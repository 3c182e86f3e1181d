"""Rank runtime: process descriptors and rank discovery."""

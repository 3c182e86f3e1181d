"""Tracing (a seam until ROADMAP Queue 1 item 14 ports it)."""

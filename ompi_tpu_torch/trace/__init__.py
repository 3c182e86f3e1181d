"""Tracing (a seam until ROADMAP Queue 1 item 9 ports it)."""

"""Unitig construction (reference asg.c / unitig.c)."""

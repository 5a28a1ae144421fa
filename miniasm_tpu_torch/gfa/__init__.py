"""GFA / BED writers (reference asg.c, main.c)."""

"""Input: the PAF loader and the read dictionary."""

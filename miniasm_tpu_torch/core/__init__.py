"""Hit -> arc classification (reference miniasm.h:86-104)."""

"""Read selection (Steps 2-3) on the device."""

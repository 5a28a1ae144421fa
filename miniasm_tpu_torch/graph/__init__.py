"""String graph, device detection and the ordered host commit."""

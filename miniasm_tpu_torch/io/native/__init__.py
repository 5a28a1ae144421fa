"""Host C++ runtime: the pipelined PAF loader and the exact radix argsort.

Compiled on demand from the sources in this directory (see build.py)."""

"""Host C++ runtime: the PAF loaders, the exact radix argsort, the -f and
-R streams (fastx.cpp) and the native graph finalizer (finalize.cpp).

Compiled on demand from the sources in this directory (see build.py)."""

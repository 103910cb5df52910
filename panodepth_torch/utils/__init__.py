"""Host utilities of the port (``nativeio``: the native PNG codec, the PFM
reader and the threaded prefetcher)."""

"""Host utilities: the TGA codec, its native C++ path and the render counters."""

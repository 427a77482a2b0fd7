"""Host utilities: the TGA codec and the render counters."""

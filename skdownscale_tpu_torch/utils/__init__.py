"""Host utilities: calendars, native grid packing, the prefetching feed."""

"""The benchmark harness: what every cell's run shares (cells, clocks,
spans, traces, peaks, the comparison that decides ``correct``)."""

"""The harness: cells, the traffic driver, the profiler and the judge."""

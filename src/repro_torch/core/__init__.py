"""The resource model, planner, schedule IR and micro-benchmarks: the
port's own copies of ``repro.core``'s pure-Python modules, and an
``H100`` platform."""

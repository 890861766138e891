"""The safety stage on the host: CommonRoad-subset IO, scenario
conversion, motion primitives, A* planning, collision checking, the five
metrics and plots. numpy f64 and a small C++ collision core; no torch."""

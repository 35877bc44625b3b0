"""The benchmark's shared code: finding files by name, reducing a trace,
and the readers that several metrics share."""

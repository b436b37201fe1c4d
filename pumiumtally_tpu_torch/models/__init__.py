"""Models built on the walk: the streaming batch pipeline, the benchmark
problems and the synthetic transport loop."""

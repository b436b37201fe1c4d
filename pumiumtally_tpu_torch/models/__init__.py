"""Models built on the walk: the streaming batch pipeline, the benchmark
problems, the synthetic transport loop and the depletion loop."""

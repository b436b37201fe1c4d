"""Models built on the walk: the streaming batch pipeline."""

"""Distributed-training building blocks: natural compression, data
parallelism, the parameter-server and replay-shard state."""

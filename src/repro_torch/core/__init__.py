"""Distributed-training building blocks; so far natural compression."""

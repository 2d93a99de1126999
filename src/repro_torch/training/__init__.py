"""The sweep engine and its execution backend."""

"""Host-side runtime of the serving engine: the request scheduler and
the KV block allocator."""

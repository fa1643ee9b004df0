"""Serving stack of the port: allocator, scheduler, load generator, paged
KV pool, step cells and the continuous-batching engine."""

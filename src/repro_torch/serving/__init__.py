"""Serving: the continuous-batching engine and its page allocator."""

"""The paged KV cache's host side: the page allocator (`pages`), the decode
session (`session`) and the continuous-batching scheduler (`scheduler`)."""

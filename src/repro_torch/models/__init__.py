"""The model zoo of the port. It holds only RWKV6's chunked scan so far
(``rwkv.rwkv_chunk_scan``, the plain version of the RWKV kernel)."""

"""Model layers of the port: layers, attention, paged KV cache, transformer
stack and the ``Model`` facade."""

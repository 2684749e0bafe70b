"""Runtime of the port: the decode servers (``server``) and their compiled
step (``steps``), the double-buffered EP decode loop (``decode``) and the
micro-batched HT prefill (``prefill``)."""

"""Runtime of the port: the decode servers (``server``) and the
micro-batched HT prefill driver (``prefill``)."""

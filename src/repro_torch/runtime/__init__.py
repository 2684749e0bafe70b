"""Runtime of the port: the decode servers (``server``) and their compiled
step (``steps``), the double-buffered EP decode loop (``decode``), the
micro-batched HT prefill (``prefill``), and training: the micro-batched
train step (``steps.make_train_step``) and its loop (``trainer``)."""

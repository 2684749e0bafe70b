"""Process meshes and launchers: one EP rank per process (port of
``src/repro/launch/mesh.py``, ``train.py parse_mesh`` and ``serve.py``),
and the training launcher (``train.py``)."""

"""The EP kernels: plain PyTorch versions (``ref``), hand-written Hopper
kernels (one wrapper module each, built by ``_build``) and the routing layer
(``ops``)."""

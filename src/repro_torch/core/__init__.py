"""FMplex core of the PyTorch port: vFMs, BFQ, physical FMs, the executor,
the decode engine, the event loop and the server (``core.server``)."""

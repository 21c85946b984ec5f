"""Tools of the port: ``profile_decode`` (measurements on the card),
``make_golden_checkpoint`` (trains and exports golden-tiny) and ``eval``
(the RAG evaluation suite, ``eval.live`` through the chain server)."""

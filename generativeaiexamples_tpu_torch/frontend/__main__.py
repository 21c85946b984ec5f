"""``python -m generativeaiexamples_tpu_torch.frontend`` — the frontend's
CLI (``server.main``)."""

from .server import main

main()

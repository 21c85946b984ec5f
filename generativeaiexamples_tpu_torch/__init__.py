"""PyTorch/CUDA port of the serving stack, for one NVIDIA H100.

The JAX package ``generativeaiexamples_tpu`` is the reference; this package
mirrors its module layout (``ops/``, ``models/``, ``engine/``,
``serving/``, ``chains/``, ``embed/``, ``retrieval/``, ``router/``,
``obs/``, ``utils/``, ``assistant/``, ``frontend/``, ``ingest/``,
``integrations/``; ``training.py`` and ``lora.py`` for fine-tuning on
torch autograd; ``tools/`` with ``profile_decode``,
``make_golden_checkpoint`` and the ``eval`` suite) and imports nothing
from it. Plain tensor code is PyTorch;
each Pallas kernel of the reference becomes a hand-written Hopper kernel
under ``csrc/``, built at first use by ``kernels/build.py``.

Entry points default to ``device="cuda"`` and raise when no CUDA device is
present, unless the caller asks for ``"cpu"`` (the tests do).
"""

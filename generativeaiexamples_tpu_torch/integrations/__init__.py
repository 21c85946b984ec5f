"""Connector classes for third-party orchestration frameworks (a port of
the reference package's ``integrations`` package, its ``Tpu*`` classes
named ``Torch*`` here):

- ``langchain_torch``  — ``TorchLLM`` and ``TorchJobsLLM`` (LangChain
  ``LLM``) and ``TorchEmbeddings`` (LangChain ``Embeddings``) over the
  model server's gRPC, OpenAI-compatible HTTP or job endpoints.
- ``llamaindex_torch`` — ``TorchLlamaIndexLLM`` (LlamaIndex
  ``CustomLLM``) and ``TorchLlamaIndexEmbedding`` over the same
  endpoints.

Both modules import-degrade: when langchain/llama_index are not
installed, the classes derive from small structural stand-ins with the
same method contracts, so the connector logic stays importable and
testable anywhere.
"""

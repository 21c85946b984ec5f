"""HTTP serving surface of the port: the model server's OpenAI-style
routes, ``/v1/score``, ``/health``, ``/metrics``, the ``/debug/*`` and
``/control/incident`` routes and the profiler routes over one engine."""

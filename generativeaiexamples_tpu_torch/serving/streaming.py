"""Bridging the engine's thread-world streams into asyncio responses (a
copy of the reference package's ``serving/streaming.py``)."""

from __future__ import annotations

import asyncio
from typing import AsyncIterator, Iterator

_SENTINEL = object()


async def iterate_in_thread(it: Iterator[str],
                            on_cancel=None) -> AsyncIterator[str]:
    """Drive a blocking iterator on the default executor, yielding into the
    event loop with no polling: the producer thread hands each item to an
    asyncio.Queue via ``call_soon_threadsafe``. The producer never blocks
    on a dead consumer (the queue is unbounded; a cancelled consumer flips
    ``done`` and the producer drains out on its next item).

    ``on_cancel`` fires when the consumer abandons the iterator before it
    is exhausted (e.g. HTTP client disconnect) — pass the engine stream's
    ``cancel`` so abandoned requests release their decode slot instead of
    generating to max_tokens."""
    loop = asyncio.get_running_loop()
    q: "asyncio.Queue" = asyncio.Queue()
    done = False
    exhausted = False

    def _put(item) -> None:
        try:
            loop.call_soon_threadsafe(q.put_nowait, item)
        except RuntimeError:
            pass  # loop already closed — consumer is long gone

    def produce() -> None:
        try:
            for chunk in it:
                if done:
                    break
                _put(chunk)
        except BaseException as exc:  # noqa: BLE001 — surface in consumer
            _put(exc)
        finally:
            _put(_SENTINEL)

    producer = loop.run_in_executor(None, produce)
    try:
        while True:
            item = await q.get()
            if item is _SENTINEL:
                exhausted = True
                break
            if isinstance(item, BaseException):
                exhausted = True
                raise item
            yield item
    finally:
        done = True
        if not exhausted and on_cancel is not None:
            on_cancel()
        await producer

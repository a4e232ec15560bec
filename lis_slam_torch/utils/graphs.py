"""CUDA-graph replay of a fixed-shape chain of launches.

`replay(name, fn, inputs, key)` runs `fn(*inputs)`: a chain of device ops
that never waits on the card and whose shapes depend on no data, over the
tensors `inputs`, with whatever else it reads folded into the hashable
`key` (frozen configs). On the card, the first call of a signature (name,
each input's shape, dtype and device, key) runs the chain eagerly and
then captures it as a CUDA graph, on a side stream, with its own copy of
the inputs and its own memory pool. Every later call of that signature
copies the inputs in, replays the graph on the current stream, and hands
back the results on fresh memory: each is rebuilt on a copy of the
storage the graph wrote it in, at the same offset and strides, so nothing
returned aliases a buffer that the next replay overwrites, and a result
is laid out as the eager chain lays it out. The host dispatches the
input copies, one graph launch and one launch that copies every result's
storage, instead of every op of the chain; the kernels are the chain's
own, in its order.

CPU tensors always run eagerly. The graphs are kept process-wide, one per
signature, until `clear()`; one signature is not to be replayed from two
streams at once. A chain that reads an object's memory besides its inputs
(a net's parameters) names it as `owner`: the signature then holds the
owner's identity, and the graph is dropped when the owner is freed, since
a graph replays on the addresses it captured.
"""

from __future__ import annotations

import weakref
from typing import Callable, NamedTuple

import torch


class _Captured(NamedTuple):
    launch: Callable  # replays the graph on the current stream
    inputs: tuple  # the graph's input buffers
    outputs: object  # fn's results, in the graph's pool
    storages: list  # each storage the results lie in, as uint8 tensors
    views: list  # a result's (storage, dtype, offset, shape, stride)


_graphs: dict[tuple, _Captured] = {}
_streams: dict[torch.device, object] = {}


def signature(name: str, inputs, key=()) -> tuple:
    """The cache key of a chain `name` over `inputs` reading `key`."""
    return (name, tuple((tuple(t.shape), t.dtype, t.device) for t in inputs),
            key)


def replay(name: str, fn: Callable, inputs: tuple, key=(), owner=None):
    """`fn(*inputs)` through the graph of its signature (see the module
    docstring). `fn` returns tensors, or tuples and NamedTuples of them.
    `owner`: the object whose memory `fn` reads besides `inputs`; its
    graphs live no longer than it. Returns (the results, whether a replay
    gave them)."""
    if not _on_card(inputs):
        return fn(*inputs), False
    if owner is not None:
        key = (key, id(owner))
    sig = signature(name, inputs, key)
    cap = _graphs.get(sig)
    if cap is None:
        out = fn(*inputs)
        launch, static, outputs = _capture(fn, inputs)
        _graphs[sig] = _Captured(launch, static, outputs, *_plan(outputs))
        if owner is not None:
            weakref.finalize(owner, _graphs.pop, sig, None)
        return out, False
    for buf, t in zip(cap.inputs, inputs):
        buf.copy_(t)
    cap.launch()
    # the results' storages copied in one launch, each result viewed anew
    copies = [torch.empty_like(st) for st in cap.storages]
    torch._foreach_copy_(copies, cap.storages)
    stores = [c.untyped_storage() for c in copies]
    fresh = iter([torch.empty(0, dtype=dtype, device=stores[i].device)
                  .set_(stores[i], offset, shape, stride)
                  for i, dtype, offset, shape, stride in cap.views])
    return _map(lambda _t: next(fresh), cap.outputs), True


def clear():
    """Drop every captured graph, its buffers and its pool."""
    _graphs.clear()


def _on_card(inputs: tuple) -> bool:
    return all(t.is_cuda for t in inputs)


def _capture(fn: Callable, inputs: tuple):
    """(launch, the graph's inputs, its outputs) of fn captured over a
    copy of `inputs`."""
    dev = inputs[0].device
    static = tuple(torch.empty_like(t, memory_format=torch.contiguous_format)
                   .copy_(t) for t in inputs)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(dev):
        stream = _streams.get(dev)
        if stream is None:
            stream = _streams[dev] = torch.cuda.Stream(dev)
        with torch.cuda.graph(graph, stream=stream):
            out = fn(*static)

    def launch():
        with torch.cuda.device(dev):
            graph.replay()

    return launch, static, out


def _plan(outputs):
    """The distinct storages of `outputs`' tensors, and where each tensor
    lies in its storage: results that share a storage in the chain get
    one copy of it, and each its own offset and strides there."""
    storages, index, views = [], {}, []
    for t in _leaves(outputs):
        st = t.untyped_storage()
        i = index.setdefault(st.data_ptr(), len(storages))
        if i == len(storages):
            storages.append(torch.empty(0, dtype=torch.uint8,
                                        device=t.device).set_(st))
        views.append((i, t.dtype, t.storage_offset(), tuple(t.shape),
                      t.stride()))
    return storages, views


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for v in tree for t in _leaves(v)]


def _map(f, tree):
    if isinstance(tree, torch.Tensor):
        return f(tree)
    items = (_map(f, v) for v in tree)
    return type(tree)(*items) if hasattr(tree, "_fields") else \
        type(tree)(items)

"""The decode step as one captured CUDA graph.

The JAX engine runs each decode step as one compiled program: ``decode_step``
is ``jax.jit`` with the pools donated (``sgl_kernel_tpu/models/llama.py:340``,
``mixtral.py:140``, ``deepseek.py:357`` and ``:667``), and with
``decode_burst > 1`` several greedy steps run in one jitted ``lax.scan``
(``sgl_kernel_tpu/serving/engine.py:585-616``). There ``jit`` is a
decorator, so this module has no JAX counterpart file. Here a step is
captured once into a CUDA graph and replayed, so a step costs the host one
input copy and one graph launch instead of one Python call per kernel.

``DecodeInputs`` holds a step's inputs at fixed addresses: tokens,
positions, lengths, slot_loc, state_slots [max_batch] and the page tables
[max_batch, max_pages] are views of one int32 buffer on the device, filled
each step from one host staging buffer (pinned on the card) by one copy.
``state_slots`` is each row's slot in the per-request state of an adapter
that keeps one (``needs_state_slots``: DeepSeek's compression rings); a
step passes it to such an adapter's decode and to no other.
``DecodeGraph`` runs a step function over those inputs. On the card the
first call warms the function up eagerly on a side stream (Triton compiles,
nvcc libraries load, ``utils.kept_buffer`` workspaces reach their size),
then captures it under ``torch.cuda.graph``; every call replays it and
returns the same static output tensor. The warm-up runs the step once more
than the engine asked for: a step that only rewrites its rows (KV stores,
ring writes) rewrites them alike, but one that advances a recurrent state
in place (hybrid GDN's conv and SSM rows) would advance it twice, so the
tensors passed as ``restore`` are saved before the warm-up and put back
after it. A capture that fails raises: there is no eager fallback. On the CPU, or when the caller asks for ``eager``, the
function runs eagerly on the same static inputs; on the CPU the first call
records the tally below as a capture would.

A replay does not pass through the kernels' Python wrappers, so their
launch counters (``launches``, ``launches_576``, ``launches_by_route`` and
``launches_by_option`` of every wrapper in ``KERNELS``) would not move. The capture records how far
each counter moved while the step was captured (``LaunchTally``), puts the
counters back (nothing ran), and every replay adds that tally again: the
counts stay those of the kernels the device ran.

The graph bakes in every pointer it saw: the static inputs, the weights,
the pools (updated in place by the step), the kept workspaces and any TMA
map encoded from them. None of them may move while the graph lives, and
replays must be ordered on one stream, since the kept split counters and
workspaces are shared by every call of their kernel on the card.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

Counter = Tuple[str, str, Optional[str]]  # (kernel name, counter attribute, route key or None)


def _counters() -> Iterator[Tuple[Counter, object]]:
    from .. import KERNELS  # the package imports this module: resolved at call time

    for name, fn in KERNELS.items():
        yield (name, "launches", None), fn
        if hasattr(fn, "launches_576"):
            yield (name, "launches_576", None), fn
        for attr in ("launches_by_route", "launches_by_option"):
            for key in getattr(fn, attr, {}):
                yield (name, attr, key), fn


def _snapshot() -> Dict[Counter, int]:
    return {c: getattr(fn, c[1]) if c[2] is None else getattr(fn, c[1])[c[2]] for c, fn in _counters()}


def _add(counts: Dict[Counter, int], sign: int = 1):
    for c, fn in _counters():
        n = counts.get(c, 0)
        if not n:
            continue
        if c[2] is None:
            setattr(fn, c[1], getattr(fn, c[1]) + sign * n)
        else:
            getattr(fn, c[1])[c[2]] += sign * n


class LaunchTally:
    """The launches of the kernels' wrappers between two snapshots of their
    counters: what one replay of a captured graph launches."""

    def __init__(self, before: Dict[Counter, int], after: Dict[Counter, int]):
        self.deltas = {c: after[c] - before[c] for c in after if after[c] != before[c]}

    def apply(self):
        """Count one replay's launches on the wrappers."""
        _add(self.deltas)

    def counts(self) -> Dict[str, int]:
        """The tally under the names ``launch_counts()``,
        ``head_dim_launch_counts()``, ``route_launch_counts()`` and
        ``option_launch_counts()`` use: ``name``, ``name_576``,
        ``name_<route>`` and ``name_<option>``."""
        out = {}
        for (name, attr, key), n in self.deltas.items():
            out[name if attr == "launches" else f"{name}_576" if key is None else f"{name}_{key}"] = n
        return out


class DecodeInputs:
    """A decode batch's inputs at fixed device addresses: views of one int32
    buffer, filled from one host staging buffer by one copy a step."""

    _ROWS = 5  # tokens, positions, lengths, slot_loc, state_slots

    def __init__(self, device, max_batch: int, max_pages: int):
        self.device = torch.device(device)
        self.max_batch, self.max_pages = max_batch, max_pages
        rows = self._ROWS * max_batch
        n = rows + max_batch * max_pages
        on_card = self.device.type == "cuda"
        self._host = torch.zeros(n, dtype=torch.int32, pin_memory=on_card)
        self._host_np = self._host.numpy()
        self._dev = torch.zeros(n, dtype=torch.int32, device=self.device)
        self._copied = torch.cuda.Event() if on_card else None
        (self.tokens, self.positions, self.lengths, self.slot_loc,
         self.state_slots) = self._dev[:rows].view(self._ROWS, max_batch)
        self.tables = self._dev[rows:].view(max_batch, max_pages)

    def fill(self, tokens, positions, lengths, slot_loc, tables, state_slots):
        """Copy one step's arrays ([max_batch] each, tables [max_batch,
        max_pages]) into the static tensors."""
        if self._copied is not None:
            self._copied.synchronize()  # the last step's copy has read the staging buffer
        b = self.max_batch
        h = self._host_np
        for i, a in enumerate((tokens, positions, lengths, slot_loc, state_slots)):
            h[i * b: (i + 1) * b] = a
        h[self._ROWS * b:] = np.asarray(tables).reshape(-1)
        self._dev.copy_(self._host, non_blocking=self._copied is not None)
        if self._copied is not None:
            self._copied.record()

    def args(self):
        """The adapter's decode argument order: tokens, positions, page
        tables, lengths, slot_loc, then state_slots."""
        return self.tokens, self.positions, self.tables, self.lengths, self.slot_loc, self.state_slots


class DecodeGraph:
    """``fn(tokens, positions, tables, lengths, slot_loc, state_slots) ->
    tensor`` over ``inputs``: captured into a CUDA graph at the first call
    on the card and replayed after; eager on the CPU or when asked."""

    def __init__(self, fn: Callable[..., torch.Tensor], inputs: DecodeInputs, restore=()):
        self.fn, self.inputs = fn, inputs
        self.restore = tuple(restore)  # state the step advances in place: undone after the warm-up
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Optional[torch.Tensor] = None
        self.tally: Optional[LaunchTally] = None
        self.replays = 0

    def __call__(self, eager: bool = False) -> torch.Tensor:
        if self.inputs.device.type != "cuda" and self.tally is None:
            # the CPU's first call stands where the card captures: its tally
            # is what one call launched (it ran, so the counters stay)
            before = _snapshot()
            out = self.fn(*self.inputs.args())
            self.tally = LaunchTally(before, _snapshot())
            return out
        if eager or self.inputs.device.type != "cuda":
            return self.fn(*self.inputs.args())
        if self.graph is None:
            self._capture()
        self.graph.replay()
        self.tally.apply()
        self.replays += 1
        return self.out

    def _capture(self):
        dev = self.inputs.device
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):  # warm-up: compiles, loads and sizes everything the step needs
            saved = [t.clone() for t in self.restore]
            self.fn(*self.inputs.args())
            for t, s in zip(self.restore, saved):
                t.copy_(s)
            del saved
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = _snapshot()
        try:
            with torch.cuda.graph(graph):
                out = self.fn(*self.inputs.args())
            after = _snapshot()
        finally:
            _add({c: n - before[c] for c, n in _snapshot().items()}, -1)  # a capture runs nothing
        self.graph, self.out, self.tally = graph, out, LaunchTally(before, after)

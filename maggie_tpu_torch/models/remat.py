"""Rematerialisation of the train forward (port of ``make_train_step(remat=)``,
``maggie_tpu/engine/train_step.py:53-98``).

Modes, as ``cfg.model.remat`` names them:

- ``"none"`` (or False): autograd keeps every activation;
- ``"full"`` (or True): the whole train forward, losses included, runs in one
  ``torch.utils.checkpoint`` segment and is recomputed once in the backward;
- ``"selective"``: the train forward runs as a sequence of segments that end
  where the JAX package tags ``checkpoint_name(x, "stage")``; a segment's
  inputs are kept and everything inside it is recomputed in its backward.

The segments of ``"selective"`` (``MaGGIe._train_forward`` and
``ResShortCutInstMattSpconvDec.train_forward``), against the JAX tags:

1. the encoder, out to ``out`` and ``fea1``-``fea5``
   (``maggie_tpu/models/encoder.py:174-185``);
2. ASPP, out to ``embedding`` (``maggie_tpu/models/maggie.py:137``);
3. ``layer1``/``layer2`` and the os8 attention, out to ``x_os8_logit`` and
   ``feat8`` (``maggie_tpu/models/decoder_sparse.py:537-538``);
4. the os8 upsample, K2's uncertainty map and rung 1, out to ``x4_dense``
   (``:313``);
5. rung 2, out to ``x2_dense`` (``:365``);
6. rung 3, the fusion (on video the bidirectional diff-module fusion and the
   temporal losses) and the losses.

The JAX video decoder tags neither ``x_os8_logit`` nor ``feat8``
(``maggie_tpu/models/decoder_video.py:154-163``), so there segments 3 and 4
are one; the dense oracle ladder (``predict_details``) tags neither ``x4`` nor
``x2``, so there segments 4 to 6 are one. The baselines' layouts follow the
same tags:

- the harness with a dense decoder (``MGM``, ``MGM_SingInst`` and the dense
  InstMatt decoder, which tag nothing past ASPP): segments 1 and 2 as
  above, then the decoder, the fusion and the losses as one (3 segments);
- ``TCVOM`` and ``TCVOM_SingInst`` (``tcvom.py``), which tag only the
  encoder's outputs: the encoder, then the rest (2 segments);
- ``SparseMat`` and ``SparseMat_SingInst`` (``sparsemat.py``), which tag
  nothing: one segment, as ``full``.

Besides the tagged tensors, a
segment hands the next the small values that the JAX package recomputes
instead: the tokens, the attention loss, the block indices and masks, the
os8 alpha, the uncertainty map and the os4 logits (on video also ``feat8``,
which the diff module reads without gradient, 8 MB at clip 8 x 512x512).

The recompute is a replay of the first pass. Four things of the forward are
not pure functions of a segment's inputs, and each segment's record
(``_Record``) holds what its recompute needs to take them as the first pass
did:

- the draws from the step's ``torch.Generator`` (the FFN dropout, the random
  dilation widths): the generator's state as the segment starts, set during
  the recompute and put back after it (``preserve_rng_state`` covers only the
  global generators);
- BatchNorm's running statistics: the recompute does not step them
  (``replaying()``);
- the spectral-norm power steps: each step's starting u, read from the
  buffer or taken from the chain of the module's previous step in the same
  forward (``layers._SpectralNorm``); the recompute starts each step from the
  same u (``sn_replay()``) and writes nothing back;
- the blocks of the ladder (``select_blocks``): a stable sort over exact
  counts, so the recompute picks the same ones; ``check_replay`` makes
  ``replayed()`` compare them.
"""

from __future__ import annotations

import contextlib
import threading

import torch
from torch.utils.checkpoint import checkpoint

MODES = ("none", "full", "selective")

# debug: compare the values passed to ``replayed()`` in each recompute with the
# first pass's; ``replay_checks`` counts the comparisons that passed
check_replay = False
replay_checks = 0


class _Stacks(threading.local):
    """The segments whose first pass or recompute runs on this thread (a
    CUDA backward, and with it a recompute, runs on autograd's own thread)."""

    def __init__(self):
        self.recording: list[_Record] = []
        self.replaying: list[_Replay] = []


_stacks = _Stacks()


def remat_mode(value) -> str:
    """``cfg.model.remat`` as one of ``MODES``: False and ``"none"`` store
    everything, True and ``"full"`` recompute the whole forward. Any other
    value raises (the JAX package takes any other truthy string for
    ``"full"``)."""
    if value is None or value is False:
        return "none"
    if value is True:
        return "full"
    mode = str(value).lower()
    mode = {"false": "none", "true": "full"}.get(mode, mode)
    if mode not in MODES:
        raise ValueError(f"model.remat must be one of {list(MODES)} (or False / True), "
                         f"not {value!r}")
    return mode


class _Record:
    """What one segment's first pass did that its recompute replays."""

    def __init__(self, generator: torch.Generator | None):
        self.generator = generator
        self.rng_state = None
        self.sn: list = []        # (module, starting u or None for the chain), in call order
        self.values: list = []    # ``replayed()`` values, in call order

    @contextlib.contextmanager
    def forward(self):
        if _stacks.recording or _stacks.replaying:
            raise RuntimeError("remat segments do not nest")
        self.sn.clear()
        self.values.clear()
        if self.generator is not None:
            self.rng_state = self.generator.get_state()
        _stacks.recording.append(self)
        try:
            yield
        finally:
            _stacks.recording.pop()

    @contextlib.contextmanager
    def recompute(self):
        g = self.generator
        after = None
        if g is not None:
            after = g.get_state()
            g.set_state(self.rng_state)
        _stacks.replaying.append(_Replay(self))
        try:
            yield
        finally:
            _stacks.replaying.pop()
            if g is not None:
                g.set_state(after)

    def contexts(self):
        return self.forward(), self.recompute()


class _Replay:
    """One recompute of a segment: its position in the record, and the chain
    of each spectral norm's recomputed steps."""

    def __init__(self, record: _Record):
        self.record = record
        self.sn_pos = 0
        self.value_pos = 0
        self.chains: dict = {}

    def sn_start(self, module) -> torch.Tensor:
        """The u the first pass's next power step of ``module`` started from."""
        m, u = self.record.sn[self.sn_pos]
        self.sn_pos += 1
        if m is not module:
            raise RuntimeError("the recompute stepped another spectral norm than the first pass")
        if u is None:
            if module not in self.chains:
                raise RuntimeError("a spectral-norm chain crosses a remat segment's start")
            u = self.chains[module]
        return u

    def sn_end(self, module, u: torch.Tensor) -> None:
        self.chains[module] = u


def replaying() -> bool:
    """True inside a recompute: BatchNorm does not step its statistics."""
    return bool(_stacks.replaying)


def sn_replay() -> _Replay | None:
    """The recompute in progress, for the spectral norms; None outside one."""
    replaying = _stacks.replaying
    return replaying[-1] if replaying else None


def note_sn_start(module, u: torch.Tensor | None) -> None:
    """First pass: ``module``'s power step starts from ``u`` (None: from the
    chain of its previous step)."""
    recording = _stacks.recording
    if recording:
        recording[-1].sn.append((module, u))


def replayed(name: str, *values: torch.Tensor) -> None:
    """Debug (``check_replay``): the recompute must reproduce ``values``."""
    global replay_checks
    if not check_replay:
        return
    replaying, recording = _stacks.replaying, _stacks.recording
    if replaying:
        rep = replaying[-1]
        if rep.value_pos >= len(rep.record.values):
            raise RuntimeError(f"remat: the recompute reached {name}, which the first pass "
                               f"did not record")
        want_name, want = rep.record.values[rep.value_pos]
        rep.value_pos += 1
        if want_name != name or not all(torch.equal(a, b) for a, b in zip(want, values)):
            raise RuntimeError(f"remat: the recompute's {name} differ from the first pass's")
        replay_checks += 1
    elif recording:
        recording[-1].values.append((name, values))


def checkpointed(fn, *args, rng: torch.Generator | None = None, **kwargs):
    """``fn(*args, **kwargs)`` in one non-reentrant checkpoint segment whose
    recompute replays the first pass (the draws from ``rng``, BatchNorm,
    spectral norm)."""
    record = _Record(rng)
    return checkpoint(fn, *args, use_reentrant=False, context_fn=record.contexts, **kwargs)


class Stages:
    """``run(fn, *args)``: one stage of the train forward, in a checkpoint
    segment of its own when ``selective``, else called as it is."""

    def __init__(self, selective: bool = False, generator: torch.Generator | None = None):
        self.selective = selective
        self.generator = generator

    def __call__(self, fn, *args):
        if not self.selective:
            return fn(*args)
        return checkpointed(fn, *args, rng=self.generator)

"""Core building blocks (port of ``maggie_tpu/models/layers.py``), NCHW.

Modules carry the original torch reference's ``state_dict`` names, so a released
MaGGIe checkpoint's tensors map by name: ``SNConv`` holds ``module.weight_bar``,
``module.weight_u``, ``module.weight_v`` (reference ``SpectralNorm(conv)``).

Mixed precision follows the JAX package: parameters stay f32 masters and are
cast to the activation dtype at use; BatchNorm and LayerNorm compute in f32 and
cast back (``maggie_tpu/models/layers.py:217-239``).

Every module with parameters has ``init_params(generator)``; ``init_weights``
walks a model and draws every parameter and buffer from one explicit
``torch.Generator``.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import remat
from .. import parallel
from ..parallel import space

EPS_L2NORM = 1e-12


def xavier_(t: torch.Tensor, fan_in: int, fan_out: int, g: torch.Generator) -> None:
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=g)


def _l2normalize(v: torch.Tensor) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v) + EPS_L2NORM)


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter and buffer of ``model`` from ``generator``, in module
    order. Spectral-norm u/v are converged by power iteration (``_sn_uv_init``)."""
    for m in model.modules():
        if hasattr(m, "init_params"):
            m.init_params(generator)
    return model


class Conv2d(nn.Conv2d):
    """Plain conv with the weight cast to the activation dtype at use."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        x, padding = space.conv_rows(x, self.padding)
        return F.conv2d(x, self.weight.to(x.dtype), b, self.stride, padding,
                        self.dilation, self.groups)

    def init_params(self, g: torch.Generator) -> None:
        rf = self.weight[0, 0].numel()
        xavier_(self.weight, self.in_channels // self.groups * rf, self.out_channels * rf, g)
        if self.bias is not None:
            nn.init.zeros_(self.bias)


class Linear(nn.Linear):
    """Linear layer computed in the activation dtype (flax ``Dense(dtype=x.dtype)``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)

    def init_params(self, g: torch.Generator) -> None:
        xavier_(self.weight, self.in_features, self.out_features, g)
        if self.bias is not None:
            nn.init.zeros_(self.bias)


class LayerNorm(nn.LayerNorm):
    """LayerNorm (eps 1e-5) with f32 statistics; output in the input dtype."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(x.dtype)

    def init_params(self, g: torch.Generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)


class Embedding(nn.Embedding):
    def init_params(self, g: torch.Generator) -> None:
        xavier_(self.weight, self.num_embeddings, self.embedding_dim, g)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d (eps 1e-5, momentum 0.1) on NCHW, computed in f32, output in
    the input dtype. ``zero_init`` starts the scale at 0 (the residual ``bn2``).

    Eval normalizes with the running statistics. Train mode is flax's
    ``nn.BatchNorm`` (``maggie_tpu/models/layers.py:217-239``): batch mean and
    variance over (N, H, W) as E[x^2] - E[x]^2 clipped at 0, and the running
    variance updated with that BIASED variance, where ``nn.BatchNorm2d`` would
    take the unbiased one. The running statistics update in place, but not
    in a remat recompute (``remat.replaying()``), which replays a forward
    that has already stepped them.

    Under data parallelism the statistics are the global batch's, as in the
    JAX package's sharded step, whatever ``model.sync_bn`` says: the ranks'
    per-channel sums of x and x^2 are all-reduced (differentiably, so the
    backward carries every rank's term) and the running statistics step from
    the global values, equal on every rank. Under row sharding a band's sums
    join every rank's (equal bands), and so do a replicated stage's copies
    (``parallel/dist.py``)."""

    def __init__(self, num_features: int, zero_init: bool = False):
        super().__init__(num_features)
        self.zero_init = zero_init

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return self._train_forward(x)
        return F.batch_norm(x.float(), self.running_mean, self.running_var, self.weight,
                            self.bias, False, 0.0, self.eps).to(x.dtype)

    def _train_forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if parallel.world() == 1:
            mean = xf.mean(dim=(0, 2, 3))
            mean_sq = (xf * xf).mean(dim=(0, 2, 3))
        else:
            sums = parallel.all_reduce_sum(torch.cat([xf.sum(dim=(0, 2, 3)),
                                                      (xf * xf).sum(dim=(0, 2, 3))]))
            mean, mean_sq = (sums / (xf.numel() // xf.shape[1] * parallel.world())).chunk(2)
        var = torch.clamp(mean_sq - mean * mean, min=0.0)
        if not remat.replaying():
            self._step_stats(mean, var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)

    @torch.no_grad()
    def _step_stats(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
        self.running_var.mul_(1 - self.momentum).add_(self.momentum * var)

    def init_params(self, g: torch.Generator) -> None:
        (nn.init.zeros_ if self.zero_init else nn.init.ones_)(self.weight)
        nn.init.zeros_(self.bias)
        self.running_mean.zero_()
        self.running_var.fill_(1.0)
        self.num_batches_tracked.zero_()


class _SNParams(nn.Module):
    """The wrapped conv's tensors, under the reference's ``<name>.module.*`` keys."""

    def __init__(self, shape: tuple[int, ...], u_len: int, v_len: int, bias: bool):
        super().__init__()
        self.weight_bar = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.empty(shape[0])) if bias else None
        self.register_buffer("weight_u", torch.empty(u_len))
        self.register_buffer("weight_v", torch.empty(v_len))


class _SpectralNorm(nn.Module):
    """Shared spectral-norm logic. Eval takes sigma = u . (W v) from the stored
    u/v with NO power step (``maggie_tpu/models/layers.py:79-97``); the reference
    steps on every forward, eval included. ``W`` is the weight flattened over all
    but its first dim: (O, I*kh*kw) for a conv, (I, O*kh*kw) for a transposed conv
    (``:149-167``). After ``fold()`` the weight already holds W / sigma and the
    u/v buffers are gone.

    Train mode (the JAX package's ``update_sn``, ``:90-96``) first runs one power
    iteration from the stored u, v = W^T u / |.|, u = W v / |.|, writes the new
    u/v back, and takes sigma from them. As in the JAX package the gradient
    flows through that step (no ``stop_gradient``): u and v are functions of W.
    A module called more than once in one forward (the video decoder's diff
    module, 14 times for 8 frames) steps from the u its previous call wrote,
    and the gradient flows back through that chain of steps as in the JAX
    package, where each call reads the traced u of the call before (where
    the conv feeds a train-mode BatchNorm, as in the diff module, that part
    of the gradient is small: the batch statistics take sigma's scale out).
    The chain is the u of the last step (``_u_live``), used while the buffer
    holds what that step wrote; ``end_sn_chains`` cuts every chain of a
    model at the end of its forward. A remat recompute (``remat.py``) starts
    each step from the u the first pass's step started from, follows its own
    chain, and writes nothing back."""

    folded: bool
    _u_live: torch.Tensor | None = None
    _u_version: int = -1

    def _sn_init(self, shape, bias: bool):
        self.module = _SNParams(shape, shape[0], math.prod(shape[1:]), bias)
        self.folded = False

    def _w_mat(self) -> torch.Tensor:
        w = self.module.weight_bar
        return w.reshape(w.shape[0], -1).float()

    def sigma(self) -> torch.Tensor:
        u, v = self.module.weight_u.float(), self.module.weight_v.float()
        return u @ (self._w_mat() @ v)

    def _power_step_sigma(self) -> torch.Tensor:
        if self.folded:
            raise RuntimeError("a folded spectral norm has no u/v to step: train the "
                               "unfolded model (fold() is for eval)")
        w = self._w_mat()
        replay = remat.sn_replay()
        if replay is not None:
            # a remat recompute: the u this step started from in the first pass
            u = replay.sn_start(self)
            v = _l2normalize(w.t() @ u)
            u = _l2normalize(w @ v)
            replay.sn_end(self, u)
            return u @ (w @ v)
        buf = self.module.weight_u
        if self._u_live is not None and buf._version == self._u_version:
            u = self._u_live
            remat.note_sn_start(self, None)
        else:
            # a copy: autograd keeps the old u, and the buffer is overwritten below
            u = buf.float().clone()
            remat.note_sn_start(self, u)
        v = _l2normalize(w.t() @ u)
        u = _l2normalize(w @ v)
        with torch.no_grad():
            buf.copy_(u)
            self.module.weight_v.copy_(v)
        if torch.is_grad_enabled():
            self._u_live, self._u_version = u, buf._version
        return u @ (w @ v)

    def weight(self, dtype: torch.dtype) -> torch.Tensor:
        w = self.module.weight_bar
        if self.training:
            w = w / self._power_step_sigma().to(w.dtype)
        elif not self.folded:
            w = w / self.sigma().to(w.dtype)
        return w.to(dtype)

    @torch.no_grad()
    def fold(self) -> None:
        if self.folded:
            return
        self.module.weight_bar.div_(self.sigma().to(self.module.weight_bar.dtype))
        del self.module.weight_u
        del self.module.weight_v
        self.folded = True

    def _sn_init_params(self, g: torch.Generator, fan_in: int, fan_out: int,
                        n_iter: int = 10) -> None:
        """Converged u/v at init (``_sn_uv_init``): a random pair underestimates
        sigma and scales fresh weights up, which blew random-init activations to
        ~1e13 in the JAX package."""
        p = self.module
        xavier_(p.weight_bar, fan_in, fan_out, g)
        if p.bias is not None:
            nn.init.zeros_(p.bias)
        if self.folded:
            return
        w = self._w_mat()
        u = _l2normalize(torch.randn(w.shape[0], generator=g))
        v = None
        for _ in range(n_iter):
            v = _l2normalize(w.t() @ u)
            u = _l2normalize(w @ v)
        with torch.no_grad():
            p.weight_u.copy_(u)
            p.weight_v.copy_(v)


def end_sn_chains(model: nn.Module) -> None:
    """Forget the spectral-norm power steps of ``model``'s last forward: the
    next forward steps every module from its stored u, as a new step does."""
    for m in model.modules():
        if isinstance(m, _SpectralNorm):
            m._u_live = None


class SNConv(_SpectralNorm):
    """Conv2d wrapped in spectral norm (reference ``SpectralNorm(conv)``)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, stride: int = 1,
                 padding: int = 1, bias: bool = False):
        super().__init__()
        self._sn_init((out_ch, in_ch, kernel_size, kernel_size), bias)
        self.stride, self.padding = stride, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = self.module.bias
        x, padding = space.conv_rows(x, self.padding)
        return F.conv2d(x, self.weight(x.dtype), None if b is None else b.to(x.dtype),
                        self.stride, padding)

    def init_params(self, g: torch.Generator) -> None:
        o, i, kh, kw = self.module.weight_bar.shape
        self._sn_init_params(g, i * kh * kw, o * kh * kw)


class SNConvTranspose(_SpectralNorm):
    """Spectral-normed ConvTranspose2d(k=4, s=2, p=1), the decoder upsampler
    (reference ``decoder/resnet.py:20,62``). Weight layout (I, O, kh, kw)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 4, stride: int = 2,
                 padding: int = 1):
        super().__init__()
        self._sn_init((in_ch, out_ch, kernel_size, kernel_size), False)
        self.stride, self.padding = stride, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.weight(x.dtype), None, self.stride, self.padding)

    def init_params(self, g: torch.Generator) -> None:
        i, o, kh, kw = self.module.weight_bar.shape
        self._sn_init_params(g, i * kh * kw, o * kh * kw)


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, slope)


def per_frame(fn, x: torch.Tensor, *rest: torch.Tensor):
    """``fn`` on each frame (slice of the leading dim) of ``x`` and ``rest``,
    concatenated (each of its outputs, where it returns a tuple): for
    frame-local eval layers on a batch of frames. At batch 3 with TF32 off,
    cuDNN's heuristics pick FFT algorithms for the decoder's os8 convs, which
    made a video window 7.7x slower on an H100 and took 14 GB more memory
    (PERF.md); a frame's result also stays the same whatever batch it came
    in."""
    if x.shape[0] == 1:
        return fn(x, *rest)
    outs = [fn(x[i:i + 1], *(r[i:i + 1] for r in rest)) for i in range(x.shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(o) for o in zip(*outs))
    return torch.cat(outs)


class BasicBlockEnc(nn.Module):
    """Encoder residual block (reference ``encoder/resnet.py:7-39``): SN conv3x3 ->
    BN -> ReLU -> SN conv3x3 -> BN (+ downsampled identity) -> ReLU."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = SNConv(in_planes, planes, 3, stride, 1)
        self.bn1 = BatchNorm(planes)
        self.conv2 = SNConv(planes, planes, 3, 1, 1)
        self.bn2 = BatchNorm(planes, zero_init=True)
        if stride != 1:
            self.downsample = nn.Sequential(nn.AvgPool2d(2, stride),
                                            SNConv(in_planes, planes, 1, 1, 0),
                                            BatchNorm(planes))
        elif in_planes != planes:
            self.downsample = nn.Sequential(SNConv(in_planes, planes, 1, 1, 0),
                                            BatchNorm(planes))
        else:
            self.downsample = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class BasicBlockDec(nn.Module):
    """Decoder residual block (reference ``decoder/resnet.py:9-45``): SN
    ConvTranspose(k4 s2 p1) upsampling when stride > 1, LeakyReLU(0.2),
    nearest-upsample + 1x1 shortcut."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        if stride > 1:
            self.conv1 = SNConvTranspose(in_planes, in_planes)
        else:
            self.conv1 = SNConv(in_planes, in_planes, 3, 1, 1)
        self.bn1 = BatchNorm(in_planes)
        self.conv2 = SNConv(in_planes, planes, 3, 1, 1)
        self.bn2 = BatchNorm(planes, zero_init=True)
        if stride > 1:
            self.upsample = nn.Sequential(nn.Upsample(scale_factor=2, mode="nearest"),
                                          SNConv(in_planes, planes, 1, 1, 0),
                                          BatchNorm(planes))
        elif in_planes != planes:
            self.upsample = nn.Sequential(SNConv(in_planes, planes, 1, 1, 0),
                                          BatchNorm(planes))
        else:
            self.upsample = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = leaky_relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.upsample is None else self.upsample(x)
        return leaky_relu(out + identity)


def res_layer_enc(in_planes: int, planes: int, blocks: int, stride: int) -> nn.Sequential:
    """Reference ``_make_layer`` (``encoder/resnet.py:106-128``)."""
    layers = [BasicBlockEnc(in_planes, planes, stride)]
    layers += [BasicBlockEnc(planes, planes, 1) for _ in range(1, blocks)]
    return nn.Sequential(*layers)


def res_layer_dec(in_planes: int, planes: int, blocks: int, stride: int) -> nn.Sequential:
    """Reference ``decoder/resnet.py:110-132``."""
    layers = [BasicBlockDec(in_planes, planes, stride)]
    layers += [BasicBlockDec(planes, planes, 1) for _ in range(1, blocks)]
    return nn.Sequential(*layers)


class MLP(nn.Module):
    """Reference ``module/mask_attention.py:194-206``: Linear stack with ReLU between."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, num_layers: int):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x

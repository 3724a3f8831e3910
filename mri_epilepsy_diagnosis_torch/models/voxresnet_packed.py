"""Packed-layout (space-to-depth) execution of VoxResNet: the eval and
train forward and the train and eval steps (counterpart of the JAX
package's `models/voxresnet_packed.py`).

The trunk of `models/cnn.py::VoxResNet` runs on the packed `(N, S/2, S/2,
S/2, 8C)` layout of `ops/packed.py`, from the same module and its
parameters, with every conv on kernel B1 (`conv2_packed`) at stride 2:
- the stem (k=3, stride 2) packs INTO the layout: `pack4` and one k=2
  pad-1 B1 launch emit the shifted packing of its output
  (`conv_input_packed_s2_p4`); at stride 1 the stem is one cuDNN conv
  (`conv_input_packed`);
- `conv3d_2` runs shifted -> aligned; each residual block alternates
  aligned -> shifted -> aligned (`conv3_packed_as` / `conv3_packed`), so
  the identity skip adds in the aligned layout;
- each downsample (k=3, stride 2) is aligned -> aligned at the next scale
  (`conv3s2_packed_aa`: one B1 launch over the low-padded input, then
  `pack2`);
- every train-mode BatchNorm is one `ops/packed.py::BnActTrainPacked`
  (the four passes of `csrc/bn_train_packed.cu` on CUDA): fine-exact
  batch statistics over the real voxels of a shifted or aligned tensor,
  with the ReLU that follows it as a slope of 0 and the shifted pads
  zeroed (the stem's BN and each block's `bn1`, shifted; `batch_norm_2`
  and the stage BNs, aligned), or with no activation (each block's
  `bn2`, before the residual add); the running statistics move by
  torch's rule.  22 such sites a step at 4 stages.
At stride 2 a train step launches B1 22 times forward (the stem,
`conv3d_2`, 4 downsamples and 16 block convs at n_blocks 4) and 21 times
for input gradients (all but the stem's, whose input takes none); the
weight gradients are `ops/packed.py::_dw_packed_qgroup`'s GEMMs.  In eval
mode the stem's and each block's first conv run BN, ReLU and the pad
zeroing as B1's B2 epilogue (`conv3_packed_as_bn_act`, slope 0, the conv
bias folded into the shift); the other BNs take the running statistics.

Dropout draws through `ops/functional.py::dropout` from the caller's
generator, as the fine `VoxResNet.forward` does, so for one generator
state the packed and the fine step draw the same mask (JAX's packed path
draws another mask than its fine one).  The ReLUs outside a BatchNorm
(after the residual add) are `jnp.maximum(x, 0)`'s (`F.maximum0`), as in
JAX's packed forward.

`train/classification.py::run_one_epoch(..., packed=True)` trains and
evaluates a VoxResNet through `voxresnet_class_step_packed` and
`voxresnet_eval_step_packed`; under a torch profiler their parts are the
`cls::forward`, `cls::backward`, `cls::optimizer` and `cls::stats` spans.
On the card its train steps after the first replay two CUDA graphs
(`GraphedTrainStep`), so the host no longer paces them.  `launch_split`
reads the step's B1 launches by kind (stride 1, stride 2, input
gradients) and the BatchNorm passes from the kernels' counters.

Reference: classification/models/cnn_model.py:43-101 (VoxResNet).
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
from torch import nn

from ..obs import span
from ..ops import cuda_kernels as K
from ..ops import functional as F
from ..ops import packed as P
from ..parallel import sharding as _S
from .cnn import VoxResNet, _flatten_torch_order, _linear

_relu = F.maximum0


@functools.lru_cache(maxsize=None)
def _relu_slope(device: torch.device) -> torch.Tensor:
    """The (1,) float32 zero slope that makes `BnActTrainPacked`'s PReLU a
    ReLU, made once per device (a constant: it takes no gradient)."""
    with torch.inference_mode(False):
        return torch.zeros(1, device=device)


def _bn_packed(y: torch.Tensor, bn: nn.BatchNorm3d, *, train: bool,
               shifted: bool, relu: bool, fine_size: int, batch: int):
    """BatchNorm on a packed tensor (shifted or aligned), then ReLU if
    `relu`, with the pad voxels of a shifted result zeroed.  Returns (y,
    new running statistics keyed like bn's buffers, or None in eval
    mode).  Train mode is one `BnActTrainPacked` over the real voxels'
    batch statistics; eval mode normalizes with the running ones."""
    if train:
        if (bn.eps, bn.momentum) != (P.BN_EPS, P.BN_MOMENTUM):
            raise ValueError(f"the packed train step takes BatchNorm eps "
                             f"{P.BN_EPS} and momentum {P.BN_MOMENTUM}, "
                             f"not {bn.eps} and {bn.momentum}")
        out, new = P.bn_act_train_packed(
            y, bn.weight, bn.bias, _relu_slope(y.device) if relu else None,
            (bn.running_mean, bn.running_var), shifted=shifted,
            valid=float(batch) * float(fine_size) ** 3)
        return out, {"running_mean": new[0], "running_var": new[1]}
    y = P.batch_norm_packed(y, bn.running_mean, bn.running_var, bn.weight,
                            bn.bias, bn.eps)
    if relu:
        y = _relu(y)
    if shifted:
        y = P.zero_shifted_pads(y)
    return y, None


def _bn_relu_epilogue(bn: nn.BatchNorm3d, bias: Optional[torch.Tensor]):
    """Packed (8C,) float32 scale, shift and slope of eval BN + ReLU after
    a conv with `bias`: B2's epilogue with alpha 0, the bias folded into
    the shift."""
    scale = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    shift = bn.bias.float() - bn.running_mean.float() * scale
    if bias is not None:
        shift = shift + bias.float() * scale
    return (P.tile_channel_param(scale), P.tile_channel_param(shift),
            P.tile_channel_param(torch.zeros_like(scale)))


def _basic_block_packed(xp: torch.Tensor, block: nn.Module, *, train: bool,
                        fine_size: int, batch: int):
    """BasicBlock (conv-bn-relu-conv-bn + identity, relu) on ALIGNED packed
    input, returning (ALIGNED packed output, new running statistics keyed
    like the block's buffers; empty in eval mode)."""
    new = {}
    wp1 = P.pack_weights2_as(block.conv1.weight)
    if train:
        y, ns = _bn_packed(P.conv3_packed_as(xp, wp1), block.bn1,
                           train=True, shifted=True, relu=True,
                           fine_size=fine_size, batch=batch)
        new.update({f"bn1.{k}": v for k, v in ns.items()})
    else:
        y = P.conv3_packed_as_bn_act(xp, wp1,
                                     *_bn_relu_epilogue(block.bn1, None))
    y = P.conv3_packed(y, P.pack_weights2(block.conv2.weight))
    y, ns = _bn_packed(y, block.bn2, train=train, shifted=False, relu=False,
                       fine_size=fine_size, batch=batch)
    if ns is not None:
        new.update({f"bn2.{k}": v for k, v in ns.items()})
    return _relu(y + xp), new


def dropout_draws(model: VoxResNet, n: int, device: torch.device,
                  generator: Optional[torch.Generator]
                  ) -> Optional[torch.Tensor]:
    """The (n, n_fc_units) uniform draws of a train step's Dropout mask,
    drawn as `ops/functional.py::dropout` draws them in the forward (from
    `generator_on(generator, device)`); None at rate 0, where the forward
    draws nothing."""
    if model.dropout == 0.0:
        return None
    width = model.model["fully_conn_1"].out_features
    gen = None if generator is None else F.generator_on(generator, device)
    return torch.rand((n, width), generator=gen, device=device)


def voxresnet_apply_packed(model: VoxResNet, x: torch.Tensor, *,
                           train: bool = False,
                           generator: Optional[torch.Generator] = None,
                           dropout_u: Optional[torch.Tensor] = None):
    """Packed-layout forward of `models.cnn.VoxResNet`.

    model: the VoxResNet (configuration and parameters; its train/eval
    mode is not read: `train` decides).  x: fine (N, S, S, S, 1); S /
    stride must be divisible by 2^(stages + 1), so that the packed cells
    stay even at every scale.  generator: the Dropout mask's, as for
    `model(x, generator)`; or `dropout_u`, the mask's draws made before
    (`dropout_draws`), which a captured step reads from a static buffer.
    Under a mesh it runs on the ``data`` axis only: its stride-2 convs and
    its flatten would reach across a D slab, so a spatial split raises.
    Returns (logits (N, num_classes), the new running statistics keyed
    like `model.state_dict()` when train, else None); differentiable in
    the model's parameters."""
    if _S.spatial_mesh() is not None:
        raise NotImplementedError(
            "packed VoxResNet under a spatial mesh: it runs on the data "
            "axis only (its stride-2 convs and flatten span the whole D)")
    m = model.model
    stride = m["conv3d_1"].stride[0]
    if stride not in (1, 2):
        raise ValueError(f"packed VoxResNet supports stride 1 or 2, got "
                         f"{stride}")
    n, s = x.shape[0], x.shape[1]
    if s % stride or (s // stride) % 2 ** (model.stages + 1):
        raise ValueError(f"packed VoxResNet needs S / stride divisible by "
                         f"{2 ** (model.stages + 1)}; got S = {s}")
    new_stats: Dict[str, torch.Tensor] = {}

    def bn_relu(y, name, *, shifted, fine_size):
        out, ns = _bn_packed(y, m[name], train=train, shifted=shifted,
                             relu=True, fine_size=fine_size, batch=n)
        if ns is not None:
            new_stats.update({f"model.{name}.{k}": v for k, v in ns.items()})
        return out

    def block(xp, name, fine_size):
        out, ns = _basic_block_packed(xp, m[name], train=train,
                                      fine_size=fine_size, batch=n)
        new_stats.update({f"model.{name}.{k}": v for k, v in ns.items()})
        return out

    # ---- stem: fine input -> SHIFTED packing
    c1 = m["conv3d_1"]
    f = s // stride
    if stride == 2 and not train:
        y = P.conv3_packed_as_bn_act(
            P.pack4(x), P.pack_input_weights_s2_p4(c1.weight),
            *_bn_relu_epilogue(m["batch_norm_1"], c1.bias))
    else:
        if stride == 2:
            y = P.conv_input_packed_s2_p4(
                x, P.pack_input_weights_s2_p4(c1.weight), c1.bias)
        else:
            y = P.conv_input_packed(x, P.pack_input_weights(c1.weight),
                                    c1.bias)
        y = bn_relu(y, "batch_norm_1", shifted=True, fine_size=f)
    c2 = m["conv3d_2"]
    xp = P.conv3_packed(y, P.pack_weights2(c2.weight), c2.bias)
    xp = bn_relu(xp, "batch_norm_2", shifted=False, fine_size=f)

    # ---- stages: downsample (aligned -> aligned), 2 blocks, stage BN
    for i in range(model.stages):
        conv = m[f"conv3d_{i + 3}"]
        xp = P.conv3s2_packed_aa(xp, P.pack_weights2_s2(conv.weight),
                                 conv.bias)
        f //= 2
        xp = block(xp, f"block_{2 * i + 1}", f)
        xp = block(xp, f"block_{2 * i + 2}", f)
        xp = bn_relu(xp, f"batch_norm_{i + 3}", shifted=False, fine_size=f)

    # ---- head (f^3 voxels): back to fine, torch flatten order
    h = _linear(m["fully_conn_1"], _flatten_torch_order(P.unpack2(xp)))
    if model.n_blocks < 4:
        # the reference registers `activation_6` twice for n_blocks >= 4,
        # so there is no activation after fully_conn_1 there
        h = _relu(h)
    if dropout_u is None:
        h = F.dropout(h, model.dropout, train, generator)
    elif train and model.dropout:
        h = F.dropout_core(h, dropout_u < 1.0 - model.dropout, model.dropout)
    logits = _linear(m["fully_conn_2"], h)
    return logits, (new_stats if train else None)


def voxresnet_class_step_packed(state, x: torch.Tensor, y: torch.Tensor,
                                generator: Optional[torch.Generator], *,
                                model: Optional[VoxResNet] = None,
                                before_update=None):
    """`train.classification._class_step` (train mode) through the packed
    forward: cross entropy on the logits, backward, `before_update()` if
    given, the optimizer's step, then the new running statistics stored in
    the model's buffers (`num_batches_tracked` counted).  `model` is
    `state.model`, the default.  Returns (state, loss, softmax
    probabilities), both detached, the contract of `_class_step` (on a
    mesh too: data axis only)."""
    from ..train.classification import cross_entropy
    from ..train.seg import _store_running_stats

    model = state.model if model is None else model
    if model is not state.model:
        raise ValueError("model must be the state's model")
    model.train(True)
    with span("cls::forward"):
        logits, stats = voxresnet_apply_packed(model, x, train=True,
                                               generator=generator)
        loss = cross_entropy(logits, y)
    with span("cls::backward"):
        state.optimizer.zero_grad(set_to_none=True)
        _S.backward(loss)
    if before_update is not None:
        before_update()
    with span("cls::optimizer"):
        _S.sync_gradients(model.parameters())
        state.optimizer.step()
    state.step += 1
    with span("cls::stats"):
        _store_running_stats(model, stats)
    return (state, loss.detach(),
            torch.softmax(logits.detach().float(), dim=-1))


def _cuda_graph(fn, pool=None):
    """Capture `fn` (its launches on the card) into a CUDA graph that
    draws its memory from `pool` (another graph's pool) or a new one;
    returns (replay, the graph's pool).  Capturing runs fn's Python once
    and none of its kernels."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool, capture_error_mode="relaxed"):
        fn()
    return graph.replay, graph.pool()


class GraphedTrainStep:
    """`voxresnet_class_step_packed` on the card, replayed from two CUDA
    graphs, so that the host issues two graph launches a step instead of
    the step's ~1800 kernel launches and the card, not the host, sets the
    pace.

    The first call is the eager step (the kernels are built, cuBLAS set
    up, Adam's state made).  The second captures the forward and backward
    (gradients set to None first, so that the backward writes them into
    the graph's own buffers), then the optimizer's step with the running
    statistics' store, and replays both; every later call copies its
    batch and its Dropout draws (`dropout_draws`, made eagerly from the
    generator, as the eager step's forward makes them) into the graphs'
    static inputs and replays.  `before_update` runs before the replays
    (before the update, as in the eager step): the loop's read of the
    step before then waits for the card to finish that step before this
    one is launched, so the card is not a step ahead of the host when the
    loop logs (a profiler started there sees every launch of the steps
    it covers), and idles only while two graphs are launched.  The
    optimizer's step is captured again whenever a learning rate has
    changed since (the plateau scheduler): a captured step reads the rate
    it was captured with.  A batch of another shape or dtype than the
    captured one takes the eager step.  On the card the optimizer's param
    groups are set `capturable` (Adam keeps its step counts there).

    The loss and probabilities returned are the graphs' outputs: the next
    replay overwrites them.  Under a torch profiler a step's parts are
    `cls::forward` (inputs and draws), `cls::backward` (the forward and
    backward's replay) and `cls::optimizer` (the update's).  On the card
    only, without a mesh; `capture` is `_cuda_graph`."""

    capture = staticmethod(_cuda_graph)

    def __init__(self, state):
        if next(state.model.parameters()).is_cuda:
            for group in state.optimizer.param_groups:
                group["capturable"] = True
            for p, st in state.optimizer.state.items():
                if torch.is_tensor(st.get("step")):
                    st["step"] = st["step"].to(p.device)
        self.calls = 0
        self.forward_backward = self.update = None

    def __call__(self, state, x: torch.Tensor, y: torch.Tensor,
                 generator: Optional[torch.Generator], before_update=None):
        self.calls += 1
        if self.calls == 1 or (self.forward_backward is not None
                               and self._key(x, y) != self.key):
            return voxresnet_class_step_packed(state, x, y, generator,
                                               before_update=before_update)
        model, opt = state.model, state.optimizer
        model.train(True)
        with span("cls::forward"):
            u = dropout_draws(model, x.shape[0], x.device, generator)
            if self.forward_backward is None:
                self.key = self._key(x, y)
                self.inputs = (x.clone(), y.clone(),
                               None if u is None else u.clone())
                self.forward_backward, self.pool = self.capture(
                    functools.partial(self._forward_backward, state))
            else:
                for static, t in zip(self.inputs, (x, y, u)):
                    if t is not None:
                        static.copy_(t)
        if before_update is not None:
            before_update()
        with span("cls::backward"):
            self.forward_backward()
        with span("cls::optimizer"):
            lrs = [group["lr"] for group in opt.param_groups]
            if self.update is None or lrs != self.lrs:
                self.update = None
                self.update, _ = self.capture(
                    functools.partial(self._update, state), self.pool)
                self.lrs = lrs
            self.update()
        state.step += 1
        return state, self.loss, self.probs

    @staticmethod
    def _key(x, y):
        return x.shape, x.dtype, y.shape, y.dtype

    def _forward_backward(self, state):
        from ..train.classification import cross_entropy

        x, y, u = self.inputs
        state.optimizer.zero_grad(set_to_none=True)
        logits, self.stats = voxresnet_apply_packed(state.model, x,
                                                    train=True, dropout_u=u)
        loss = cross_entropy(logits, y)
        loss.backward()
        self.loss = loss.detach()
        self.probs = torch.softmax(logits.detach().float(), dim=-1)

    def _update(self, state):
        from ..train.seg import _store_running_stats

        state.optimizer.step()
        _store_running_stats(state.model, self.stats)


@torch.no_grad()
def voxresnet_eval_step_packed(state, x: torch.Tensor, y: torch.Tensor):
    """`train.classification._class_step` in eval mode through the packed
    eval forward (running statistics, no Dropout, B2 fused at the
    aligned->shifted convs).  Returns (state, loss, softmax
    probabilities)."""
    from ..train.classification import cross_entropy

    state.model.train(False)
    with span("cls::forward"):
        logits, _ = voxresnet_apply_packed(state.model, x, train=False)
        loss = cross_entropy(logits, y)
    return state, loss, torch.softmax(logits.float(), dim=-1)


BN_PASSES = ("bn_train_stats", "bn_train_apply", "bn_train_reduce",
             "bn_train_dx")


def reset_launch_counts() -> None:
    """Zero the kernels' launch counters that `launch_split` reads."""
    K.reset_launch_counts()
    P.conv3s2_packed_aa.launches = 0
    P.conv_input_packed_s2_p4.launches = 0


def launch_split() -> Dict[str, int]:
    """Launches on the card since `reset_launch_counts`: B1 by kind
    (`b1_stride1`, `b1_stride2`: the stem and the downsamples, `b1_dx`:
    input gradients) and each pass of `BnActTrainPacked`.  A packed train
    step at stride 2 and 4 stages reads 17, 5, 21 and 22 of each pass."""
    stride2 = (P.conv3s2_packed_aa.launches
               + P.conv_input_packed_s2_p4.launches)
    dx = K.conv2_packed_dx.launches
    return {"b1_stride1": K.conv2_packed.launches - dx - stride2,
            "b1_stride2": stride2, "b1_dx": dx,
            **{name: getattr(K, name).launches for name in BN_PASSES}}

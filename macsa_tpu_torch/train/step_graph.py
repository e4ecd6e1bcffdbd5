"""The train step as one CUDA graph: captured once for a batch shape, then
replayed every step.

A bf16 train step of the port issues thousands of kernels (the text
encoder, the fusion, the loss, autograd's backward, the clip and the AdamW
update), one Python call and one launch each, and the host takes longer to
issue them than the card takes to run them.  A `torch.cuda.CUDAGraph`
replay issues the whole captured step with one host call.

`graph_mode` is the one rule that decides how a call runs, from what the
step can observe.  A call runs eagerly, as it always has, unless all of
these hold: the batch's tensors are on CUDA, no process group is set up
(a world of one: `parallel.mesh`), the optimizer is `AdamW` with
`accumulate_steps` 1, and the model holds no DeepSeek-V2 `MoE` layer (its
spans read host counts every step, which a replay would not record).
Where they hold, the batch's signature (keys, shapes, dtypes) decides:
* its first call runs eagerly ("warm", on the stream the capture will use):
  it creates the optimizer's state and every `.grad`, after the optimizer
  is made capturable (`AdamW.make_capturable`),
* its next call captures the step into a graph, with the batch copied into
  static buffers, and replays it,
* every later call copies the batch into those buffers and replays.
A new signature (the short last batch of an epoch) is thus eager once.
A `load_state_dict` of the model, the ResNet or the `AdamW` drops the
graphs (the state's addresses change); the next call of a signature
captures again.  `TrainStep.calls` counts the calls by mode.

What a replay keeps the same as the eager step, bit for bit:
* K1's dropout seeds: the step draws the same host ints from
  `DropoutRng.for_step`'s host generator, in the same order
  (`replay_kernel_seeds`), and writes them into the device words the
  captured K1 launches read (`SeedWords`), from a ring of pinned buffers,
  with no host wait,
* the elementwise dropout masks: drawn from one device generator the step
  owns, registered with every graph and re-seeded before each replay with
  the device seed `for_step` gives, so they equal those of the eager
  step's fresh generator,
* the learning rates: the schedules stay on the host (`AdamW.set_rates`),
  written into the groups' device rates before each replay,
* the host state: `state.step`, `AdamW.updates` and `cuda_lib.
  launch_counts` (the captured step's counts, added on every replay).
The metrics a call returns are fresh tensors, as the eager step's are.

On a replay the layers' spans (`text_encoder`, `fusion`, `decoder`,
`backward`, `optimizer`, `visual`) are not entered: the host does not issue
those layers.  The root span `train_step` is, on every call, with the count
`replayed` (1 on a replay, 0 otherwise).
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, Optional

import numpy as np
import torch

from macsa_tpu_torch.models.deepseek_v2 import MoE
from macsa_tpu_torch.models.layers import DropoutRng
from macsa_tpu_torch.ops import cuda_lib
from macsa_tpu_torch.parallel import mesh
from macsa_tpu_torch.train.optim import AdamW
from macsa_tpu_torch.utils.logging import span

Batch = Dict[str, torch.Tensor]
EAGER, WARM, CAPTURE, REPLAY = "eager", "warm", "capture", "replay"
_M32 = 0xFFFFFFFF


def batch_signature(batch: Batch) -> Optional[tuple]:
    """(key, shape, dtype, device type) of each value, in key order; None
    where a value is not a tensor."""
    sig = []
    for key in sorted(batch):
        v = batch[key]
        if not isinstance(v, torch.Tensor):
            return None
        sig.append((key, tuple(v.shape), v.dtype, v.device.type))
    return tuple(sig)


def holds_moe(model: torch.nn.Module) -> bool:
    return any(isinstance(m, MoE) for m in model.modules())


def graph_mode(signature: Optional[tuple], state, graphs: "TrainStep") -> str:
    """How a train step call runs: EAGER where a condition of the module's
    rule fails, else by the batch's signature: WARM (its first call, eager),
    CAPTURE (its next call, or its first after a load dropped the graphs)
    or REPLAY.  Whether the model holds an MoE layer is read once, when the
    step is made (`TrainStep.holds_moe`)."""
    opt = state.optimizer
    if (signature is None or any(device != "cuda" for *_, device in signature)
            or mesh._initialized()
            or not isinstance(opt, AdamW) or opt.accumulate_steps != 1
            or graphs.holds_moe):
        return EAGER
    if opt.loads != graphs.optimizer_loads:
        graphs.drop()
        graphs.optimizer_loads = opt.loads
    if signature in graphs.captured:
        return REPLAY
    return CAPTURE if signature in graphs.seen else WARM


def replay_kernel_seeds(seed: int, step: int, dp_index: int, offsets: list) -> list:
    """K1's seeds of step `step` as uint32, one a K1 call with its offset:
    the draws `DropoutRng.attention_seed` makes on the eager step."""
    _, host_seed = DropoutRng.step_seeds(seed, step, dp_index)
    rng = DropoutRng(None, torch.Generator().manual_seed(host_seed), dp_index)
    return [(rng.kernel_seed() + off) & _M32 for off in offsets]


class SeedWords:
    """K1's seeds of one captured step: int32 device words, one a K1 call in
    the order the step draws them, each launch's `seed_word`; and a ring of
    pinned host buffers they are copied from before each replay.  A buffer
    is written again only once its copy `RING` replays ago has run, so the
    host waits only where it runs that far ahead of the card."""

    CAPACITY = 512  # K1 calls a step may make: 12 in ViSoBERT's (a backward reuses its word)
    RING = 4

    def __init__(self, device: torch.device):
        self.words = torch.zeros(self.CAPACITY, dtype=torch.int32, device=device)
        self.offsets: list = []
        pinned = device.type == "cuda"
        self.ring = [torch.zeros(self.CAPACITY, dtype=torch.int32, pin_memory=pinned)
                     for _ in range(self.RING)]
        self.copied = [torch.cuda.Event() if pinned else None for _ in range(self.RING)]
        self.turn = 0

    def word(self, seed: int, offset: int) -> torch.Tensor:
        """The next call's word (a one-element view), its offset recorded."""
        i = len(self.offsets)
        if i == self.CAPACITY:
            raise RuntimeError(f"more than {self.CAPACITY} K1 calls in one captured step")
        self.offsets.append(offset)
        return self.words[i:i + 1]

    def write(self, seeds: list) -> None:
        n, buf, copied = len(seeds), self.ring[self.turn], self.copied[self.turn]
        if copied is not None:
            copied.synchronize()
        buf.numpy()[:n] = np.asarray(seeds, dtype=np.uint32).view(np.int32)
        self.words[:n].copy_(buf[:n], non_blocking=True)
        if copied is not None:
            copied.record()
        self.turn = (self.turn + 1) % self.RING


class CapturedStep:
    """One signature's graph: its static batch and metrics, its seed words,
    the step's device generator, and the launches the captured step counted."""

    def __init__(self, graph, static: Batch, out: Dict[str, torch.Tensor], words: SeedWords,
                 generator: torch.Generator, counts: Dict[str, int]):
        self.graph, self.static, self.out, self.words = graph, static, out, words
        self.generator, self.counts = generator, counts

    def replay(self, batch: Batch, seed: int, state, dp_index: int) -> Dict[str, torch.Tensor]:
        for key, v in batch.items():
            self.static[key].copy_(v)
        self.words.write(replay_kernel_seeds(seed, state.step, dp_index, self.words.offsets))
        self.generator.manual_seed(DropoutRng.step_seeds(seed, state.step, dp_index)[0])
        state.optimizer.set_rates()
        self.graph.replay()
        cuda_lib.launch_counts.update(self.counts)
        state.step += 1
        state.optimizer.updates += 1
        return {k: v.clone() for k, v in self.out.items()}


class TrainStep:
    """step(batch, seed) -> metrics: `body(batch, rng)` (the forward, the
    loss, its backward and `state.apply_gradients()`), eager or from a
    graph as `graph_mode` decides."""

    def __init__(self, state, body: Callable, dp_index: int):
        self.state, self.body, self.dp_index = state, body, dp_index
        self.seen: set = set()
        self.captured: Dict[tuple, CapturedStep] = {}
        self.calls: collections.Counter = collections.Counter()
        self.optimizer_loads = getattr(state.optimizer, "loads", 0)
        self.holds_moe = holds_moe(state.model)
        self._generator: Optional[torch.Generator] = None
        self._stream: Optional[torch.cuda.Stream] = None
        self._pool = None
        for module in (state.model, state.visual):
            module.register_load_state_dict_post_hook(lambda *_: self.drop())

    def drop(self) -> None:
        """Forget the graphs: the next call of a signature captures again."""
        self.captured.clear()

    def __call__(self, batch: Batch, seed: int) -> Dict[str, torch.Tensor]:
        with span("train_step", step=True) as traced:
            sig = batch_signature(batch)
            mode = graph_mode(sig, self.state, self)
            self.calls[mode] += 1
            if traced is not None:
                traced.counts["replayed"] = int(mode == REPLAY)
            if mode == EAGER:
                return self.eager(batch, seed)
            if mode == WARM:
                return self.warm(sig, batch, seed)
            if mode == CAPTURE:
                self.capture(sig, batch, seed)
            return self.captured[sig].replay(batch, seed, self.state, self.dp_index)

    def eager(self, batch: Batch, seed: int) -> Dict[str, torch.Tensor]:
        device = next(iter(batch.values())).device
        return self.body(batch, DropoutRng.for_step(seed, self.state.step, device,
                                                    self.dp_index))

    def warm(self, sig: tuple, batch: Batch, seed: int) -> Dict[str, torch.Tensor]:
        """The signature's first call: eager on the capture's stream (which
        sets up its cuBLAS workspace outside any graph)."""
        if not self.state.optimizer.capturable:
            self.state.optimizer.make_capturable()
        device = next(iter(batch.values())).device
        stream = self.stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            out = self.eager(batch, seed)
        torch.cuda.current_stream(device).wait_stream(stream)
        self.seen.add(sig)
        return out

    def capture(self, sig: tuple, batch: Batch, seed: int) -> None:
        """Capture the step into a graph; the host state it advanced and the
        launches it counted are put back (the replay that follows counts)."""
        state, opt = self.state, self.state.optimizer
        device = next(iter(batch.values())).device
        static = {k: v.clone() for k, v in batch.items()}
        words = SeedWords(device)
        generator = self.generator(device)
        dev_seed, host_seed = DropoutRng.step_seeds(seed, state.step, self.dp_index)
        generator.manual_seed(dev_seed)
        rng = DropoutRng(generator, torch.Generator().manual_seed(host_seed), self.dp_index,
                         words)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(generator)
        counts0, step0, updates0 = dict(cuda_lib.launch_counts), state.step, opt.updates
        torch.cuda.empty_cache()  # the eager step's cached blocks do not stack on the pool
        with torch.cuda.graph(graph, pool=self._pool, stream=self.stream(device),
                              capture_error_mode="thread_local"):
            out = self.body(static, rng)
        self._pool = self._pool or graph.pool()
        counts = {k: v - counts0.get(k, 0) for k, v in cuda_lib.launch_counts.items()
                  if v != counts0.get(k, 0)}
        cuda_lib.launch_counts.clear()
        cuda_lib.launch_counts.update(counts0)
        state.step, opt.updates = step0, updates0
        self.captured[sig] = CapturedStep(graph, static, out, words, generator, counts)

    def stream(self, device: torch.device) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        return self._stream

    def generator(self, device: torch.device) -> torch.Generator:
        if self._generator is None:
            self._generator = torch.Generator(device)
        return self._generator

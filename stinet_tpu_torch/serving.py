"""Serving a trained mesh-inpainting generator.

PyTorch counterpart of `SceneInpainter` in `stinet_tpu/serving.py`. A
request builds the scene's padded hierarchy on the host, moves it to the
device in ONE copy, runs the generator and returns the valid level-0 rows.

  * geometric bucket padding, so scene sizes land on a short ladder of
    shapes, and running-max table widths (`_normalize_widths`), so
    same-bucket scenes share one layout;
  * `windowed=True` builds bandwidth-ordered (RCM) hierarchies, whose banded
    tables take the windowed kernels (ops/windowed.py) where the dispatch
    rule of ops/message_passing.py sends them: bf16 at H in {128, 256}, f32
    at H = 256. Results come back in the scene's own vertex order;
  * batched dispatch (`predict_batch`) in two layouts: "stacked" builds each
    scene as its own padded graph, stacks the tensors to [B, ...] and runs
    the forward scene by scene (JAX's lax.map), each with num_graphs == 1,
    after one host-to-device copy of the whole batch; "concatenated" is one
    graph of B scenes (num_graphs == B, per-graph instance norm);
  * `predict_stream`, a pipeline of threaded host builds, one pinned copy a
    scene and a delayed, non-blocking copy back, with `stream_stats`;
  * `warmup`, which serves each distinct signature of a set of
    representative scenes once (kernels built and loaded, allocator caches
    filled, table widths settled), and `from_checkpoint`;
  * serving over a mesh of partitions (`mesh=`, parallel/mesh.py):
    `predict_partitioned` serves ONE full, uncropped scene split across the
    mesh's partitions (graph/partition.py; a ring halo exchange before each
    conv, parallel/sharded_stinet.py), the scale-out path for scenes beyond
    one device, where the reference crops offline; on a process mesh,
    `predict_batch` serves each rank its round-robin share of the scenes
    and gathers the results back in input order. `predict`,
    `predict_stream` and `warmup` are the plain server's.

Host to device: only the leaves the inference forward reads are copied,
packed into one pinned buffer (`PackedPlacer`, which the trainer's placement
shares).

Matmul precision: the forward runs its f32 matmuls (and any cuDNN
convolution) in full f32, with TF32 off (`full_f32_matmuls`), since TF32
would move the numbers away from the JAX f32 model's. The process's own
settings are restored after each forward.

`export` writes the forward at one scene's bucket signature with
torch.export (utils/model_io.py), to be run later without model code.

Not ported: `num_compiles` (eager torch keeps no compile cache; it comes
with the capture per bucket of CUDA graphs) and the wire encodings of
`stinet_tpu/transfer.py` (they wait until the copy shows in a benchmark).
"""
import collections
import concurrent.futures
import contextlib
import copy
import dataclasses
import json
import os
import threading
import time
from typing import Iterable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from stinet_tpu_torch.graph.build import (
    RawHierarchy, build_hierarchical_graph, pad_and_stack,
    pad_tables_to_widths, table_widths, windowed_layout)
from stinet_tpu_torch.graph.hierarchy import (
    EdgeSet, HierarchicalGraph, map_tensors, scene_of, tensor_leaves,
    tree_structure)


def resolve_device(device) -> torch.device:
    """torch.device for `device`; raises for a CUDA device when no card is
    visible, so nothing quietly runs on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but CUDA is not available; "
                "pass device='cpu' to run the plain versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@contextlib.contextmanager
def full_f32_matmuls():
    """Inside the block, f32 matmuls and cuDNN convolutions run in full f32
    (TF32 off for both: torch's default lets cuDNN convolutions use TF32);
    after it the process's settings are as they were."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    precision = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(precision)
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _inference_edges(e: EdgeSet, reads_coo: bool) -> EdgeSet:
    drop_coo = e.nbr is not None and not reads_coo
    return dataclasses.replace(
        e, rev_dst=None, out_degree=None,   # backward only
        src=None if drop_coo else e.src, dst=None if drop_coo else e.dst)


def inference_graph(graph: HierarchicalGraph, reads_coo: bool = False,
                    reads_labels: bool = False) -> HierarchicalGraph:
    """`graph` without the leaves the inference forward never reads: the
    target colors and mask, the backward-only reverse tables, the labels
    unless `reads_labels`, and the COO lists of edge sets that have ELL
    tables unless `reads_coo` (a model's `reads_labels` / `reads_coo`)."""
    levels = tuple(dataclasses.replace(
        lv, edges=_inference_edges(lv.edges, reads_coo),
        dilated={d: _inference_edges(e, reads_coo)
                 for d, e in lv.dilated.items()})
        for lv in graph.levels)
    return dataclasses.replace(
        graph, color=None, mask=None,
        labels=graph.labels if reads_labels else None, levels=levels)


# the bucket ladder's step (geometric buckets, as the JAX server's)
PAD_MULTIPLE = 128
# scenes of `predict_stream` whose copy back may still be in flight
INFLIGHT = 2


def _scene_order(rows: np.ndarray, order) -> np.ndarray:
    """Rows of a build's level 0 back in the scene's vertex order
    (order[row] = the scene's vertex; None: the order was kept)."""
    if order is None:
        return rows
    out = np.empty_like(rows)
    out[order] = rows
    return out


@dataclasses.dataclass
class _Packed:
    graph: HierarchicalGraph   # the host graph whose leaves were packed
    slot: int                  # the ring buffer that holds them
    total: int                 # int32 words packed


class PackedPlacer:
    """Moves a host graph to `device` in ONE host-to-device copy: every
    leaf (int32 or float32) is packed into a pinned int32 buffer, copied
    with `non_blocking=True`, and sliced back into typed views on the
    device. The placer keeps a ring of `slots` pinned buffers, used in
    turn; an event recorded after each copy guards its buffer from being
    refilled while the copy still reads it, so `slots` copies may be in
    flight at once. On a CPU device the graph is moved leaf by leaf.

    With a copy `stream`, each slot also owns the device buffer its copy
    lands in, and the copy runs on that stream, beside the work on the
    caller's stream. The caller then takes a slot's graph with `ready`
    (its stream waits for the copy) and hands the slot back with `release`
    once the work that reads the graph is enqueued; `pack` blocks until
    the slot it takes has been handed back, and the copy into it waits on
    the device for that work. So a buffer is never refilled while a
    pending step still reads it, and a graph is valid until its slot is
    released."""

    def __init__(self, device: torch.device, slots: int = 1,
                 stream: Optional["torch.cuda.Stream"] = None):
        self.device = device
        self._pinned = [None] * slots      # reusable pinned buffers (int32)
        self._copy_done = [None] * slots   # event after each one's last copy
        self._next = 0
        self._stream = stream
        if stream is not None:
            self._device_bufs = [None] * slots
            self._released = [None] * slots    # event after the last reader
            self._free = threading.Semaphore(slots)

    def __call__(self, graph: HierarchicalGraph) -> HierarchicalGraph:
        return self.put(self.pack(graph))

    def pack(self, graph: HierarchicalGraph) -> _Packed:
        """Pack the leaves of `graph` into the next buffer of the ring,
        after that buffer's last copy has ended."""
        if self._stream is not None:
            self._free.acquire()
        slot = self._next
        self._next = (slot + 1) % len(self._pinned)
        if self.device.type != "cuda":
            return _Packed(graph, slot, 0)
        leaves = tensor_leaves(graph)
        for t in leaves:
            if t.dtype not in (torch.int32, torch.float32):
                raise TypeError(f"graph leaf of dtype {t.dtype}: the packed "
                                "copy takes int32 and float32 leaves")
        total = sum(t.numel() for t in leaves)
        buf = self._pinned[slot]
        if buf is None or buf.numel() < total:
            if self._copy_done[slot] is not None:
                self._copy_done[slot].synchronize()
            buf = self._pinned[slot] = torch.empty(
                total, dtype=torch.int32, pin_memory=True)
        elif self._copy_done[slot] is not None:
            self._copy_done[slot].synchronize()
        off = 0
        for t in leaves:
            n = t.numel()
            buf[off:off + n].copy_(t.reshape(-1).view(torch.int32))
            off += n
        return _Packed(graph, slot, total)

    def put(self, packed: _Packed) -> HierarchicalGraph:
        """One non-blocking copy of a packed buffer to the device; returns
        the graph as views of the copy."""
        if self.device.type != "cuda":
            return map_tensors(packed.graph, lambda t: t.to(self.device))
        src = self._pinned[packed.slot][:packed.total]
        event = torch.cuda.Event()
        if self._stream is None:
            flat = src.to(self.device, non_blocking=True)
            event.record()
        else:
            with torch.cuda.stream(self._stream):
                if self._released[packed.slot] is not None:
                    self._stream.wait_event(self._released[packed.slot])
                # a buffer grown here is freed to this stream's pool after
                # the wait above, so no reader of it is still pending
                dbuf = self._device_bufs[packed.slot]
                if dbuf is None or dbuf.numel() < packed.total:
                    dbuf = self._device_bufs[packed.slot] = torch.empty(
                        packed.total, dtype=torch.int32, device=self.device)
                flat = dbuf[:packed.total]
                flat.copy_(src, non_blocking=True)
                event.record(self._stream)
        self._copy_done[packed.slot] = event
        offset = [0]

        def unpack(t):
            n = t.numel()
            view = flat[offset[0]:offset[0] + n].view(t.dtype).view(t.shape)
            offset[0] += n
            return view

        return map_tensors(packed.graph, unpack)

    def ready(self, slot: int) -> None:
        """The caller's current stream waits for the copy into `slot`."""
        if self._copy_done[slot] is not None:
            torch.cuda.current_stream(self.device).wait_event(
                self._copy_done[slot])

    def release(self, slot: int) -> None:
        """Hand `slot` back: the work enqueued so far on the caller's
        current stream is the last that reads it."""
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        self._released[slot] = event
        self._free.release()


def _signature(graph: HierarchicalGraph):
    """The bucket signature `warmup` dedupes on (JAX's): per level, the
    edge list length, halo and ELL width, and each dilated set's."""
    return tuple(
        (tuple(lv.edges.src.shape), lv.edges.halo,
         None if lv.edges.nbr is None else tuple(lv.edges.nbr.shape),
         tuple(sorted((d, tuple(es.src.shape), es.halo)
                      for d, es in lv.dilated.items())))
        for lv in graph.levels)


def _compile_key(graph: HierarchicalGraph):
    """What a JAX jit cache keys a graph on: its structure (treedef, with
    the static ints) and every tensor leaf's shape and dtype."""
    return (tree_structure(graph),
            tuple((tuple(t.shape), t.dtype) for t in tensor_leaves(graph)))


class _ServedForward(torch.nn.Module):
    """The server's forward as a module: the generator's f32 output."""

    def __init__(self, model: torch.nn.Module, impl: Optional[str]):
        super().__init__()
        self.model, self.impl = model, impl

    def forward(self, graph: HierarchicalGraph) -> torch.Tensor:
        return self.model(graph, impl=self.impl).float()


class SceneInpainter:
    """Serve `model(graph)` over preprocessed scene hierarchies.

    model: a port generator (models/factory.define_G); state_dict: its
    weights (reference key layout). windowed=True serves RCM-ordered
    builds (the windowed kernels) and returns colors in the scene's order.
    impl=None runs the CUDA kernels on a CUDA device; impl="plain" runs the
    plain torch versions there. The server keeps its own copy of `model`;
    the caller's is left as it is. mesh: a mesh of partitions
    (parallel/mesh.py:make_mesh) on the server's device, for
    `predict_partitioned` and, on a process mesh, `predict_batch`.
    """

    def __init__(self, model: torch.nn.Module, state_dict, *,
                 windowed: bool = False, device="cuda",
                 impl: Optional[str] = None, mesh=None):
        self.device = resolve_device(device)
        if mesh is not None and mesh.device != self.device:
            raise ValueError(f"the mesh is on {mesh.device}, the server on "
                             f"{self.device}")
        self.mesh = mesh
        self._sharded_apply = None   # built at the first predict_partitioned
        self.impl = impl
        self.windowed = windowed
        model = copy.deepcopy(model)
        model.load_state_dict(state_dict)
        self.model = model.to(self.device).eval()
        # what the forward reads beside the flagship's leaves, fixed by
        # the model's architecture
        self._reads = dict(
            reads_coo=getattr(model, "reads_coo", False),
            reads_labels=getattr(model, "reads_labels", False))
        self._placer = PackedPlacer(self.device)
        # running-max table widths keyed (level, dist, field, vertex
        # bucket); the lock makes their growth atomic under
        # predict_stream's concurrent builds
        self._widths = {}
        self._width_lock = threading.Lock()
        self._stream_stats = {}
        # the layouts served (`_serve`), as JAX's two jit caches hold them:
        # (False, key) a graph's forward, (True, key) a stacked batch's
        self._served = set()

    # -- building ------------------------------------------------------
    def _host_graph(self, scenes: Sequence[RawHierarchy]):
        return self._normalize_widths(build_hierarchical_graph(
            list(scenes), pad_multiple=PAD_MULTIPLE, geometric=True,
            windowed=self.windowed))

    def build(self, scene: RawHierarchy) -> HierarchicalGraph:
        """The scene's padded hierarchy on the host: the bucket ladder,
        windowed (RCM-ordered) if the server is, tables padded to the
        running widths."""
        return self._host_graph([scene])

    def _layout(self, scene: RawHierarchy):
        """(scene, order): the scene in its build's vertex order and that
        order (graph/build.py `windowed_layout`; None: kept)."""
        if not self.windowed:
            return scene, None
        return windowed_layout(scene)

    def _build_scene(self, scene: RawHierarchy):
        """(host graph, level-0 order) of one scene."""
        scene, order = self._layout(scene)
        return self.build(scene), order

    def _normalize_widths(self, graph: HierarchicalGraph):
        """Pad the data-dependent table dims (ELL slot width, reverse width,
        spill and edge-list lengths, children width) up to per-server
        running maxima, so same-bucket scenes share one layout. The keys
        hold the level's vertex bucket, so a large scene does not widen the
        tables of smaller buckets. Halos are not ratcheted: a halo grown for
        good would push later scenes past the windowed dispatch caps
        (a stacked batch takes its own maximum, `pad_and_stack`)."""
        target = {}
        with self._width_lock:
            for (li, dk, f), w in table_widths(graph).items():
                if f == "halo":
                    continue
                key = (li, dk, f, graph.levels[li].num_padded_vertices)
                self._widths[key] = max(self._widths.get(key, 0), int(w))
                target[(li, dk, f)] = self._widths[key]
        return pad_tables_to_widths(graph, target)

    def _build_stacked(self, scenes: Sequence[RawHierarchy]):
        """(stacked host graph, level-0 orders): each scene built as its
        own padded graph on a thread pool (the host build dominates a
        request; numpy's sorts release the GIL), then `_stack`ed. Raises
        ValueError when the scenes cannot share one layout."""
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=min(len(scenes), 8)) as ex:
            built = list(ex.map(self._build_scene, scenes))
        return self._stack([g for g, _ in built]), [o for _, o in built]

    def _stack(self, graphs: Sequence[HierarchicalGraph]):
        """Built single-scene graphs width-normalized, in order, then padded
        to the batch maximum of every width (`pad_and_stack`), which is the
        running maximum after the batch for the normalized dims and the
        batch's own for halos, and stacked to [B, ...]. Raises ValueError
        when they cannot share one layout (different buckets, or an ELL
        table that fell back to COO in one scene)."""
        return pad_and_stack([self._normalize_widths(g) for g in graphs])[0]

    def place(self, graph: HierarchicalGraph) -> HierarchicalGraph:
        """Move the leaves of a host graph (one scene, concatenated or
        stacked) that the forward reads to the device, in one copy."""
        return self._placer(self._inference_graph(graph))

    def _inference_graph(self, graph: HierarchicalGraph):
        """`inference_graph` with what this server's model reads."""
        return inference_graph(graph, **self._reads)

    # -- inference -----------------------------------------------------
    @torch.inference_mode()
    def forward(self, graph: HierarchicalGraph) -> torch.Tensor:
        """The generator on a graph already on the device, in f32 (a
        bf16 model's output is cast up)."""
        with full_f32_matmuls():
            return self.model(graph, impl=self.impl).float()

    @torch.inference_mode()
    def forward_stacked(self, graph: HierarchicalGraph) -> torch.Tensor:
        """The generator on a stacked graph already on the device, scene by
        scene (each a single-scene graph of views); [B, V0_pad, out]."""
        batch = graph.x.shape[0]
        return torch.stack([self.forward(scene_of(graph, i))
                            for i in range(batch)])

    def _serve(self, graph: HierarchicalGraph, stacked=False):
        """The forward (`forward_stacked` with `stacked`) of a placed graph,
        its layout noted for `num_compiles` as JAX's jit caches key it."""
        self._served.add((stacked, _compile_key(graph)))
        return (self.forward_stacked if stacked else self.forward)(graph)

    def predict(self, scene: RawHierarchy) -> np.ndarray:
        """Inpaint one scene; returns [num_vertices, output_nc] colors for
        the valid level-0 vertices, in the scene's vertex order."""
        graph, order = self._build_scene(scene)
        out = self._serve(self.place(graph))
        return _scene_order(out[:scene.num_vertices[0]].cpu().numpy(), order)

    def predict_batch(self, scenes: Sequence[RawHierarchy], *,
                      stacked="auto") -> List[np.ndarray]:
        """Serve B scenes in one request; returns their valid-vertex colors.

        stacked=True or "auto" takes the stacked layout; "auto" falls back
        to the concatenated one when the scenes cannot share a stacked
        layout, stacked=True raises then, and stacked=False forces the
        concatenated layout. On a process mesh of more than one rank the
        stacked layouts are served a share a rank (every rank gets every
        result); the concatenated layout is served whole on every rank."""
        if not scenes:
            return []
        mesh = self.mesh
        if stacked and mesh is not None and mesh.processes \
                and mesh.n_parts > 1:
            return self._predict_batch_sharded(scenes, stacked)
        return self._predict_batch_local(scenes, stacked)

    def _predict_batch_sharded(self, scenes, stacked):
        """A process mesh's `predict_batch`: rank r serves scenes r, r + n,
        r + 2n, ... (JAX's `local_scene_shard`, round robin) in one stacked
        request, and every rank gets every result back in input order."""
        mesh = self.mesh
        mine = list(range(mesh.rank, len(scenes), mesh.n_parts))
        outs = (self._predict_batch_local([scenes[i] for i in mine], stacked)
                if mine else [])
        results = [None] * len(scenes)
        for rank, got in enumerate(mesh.all_gather_object(outs)):
            for i, out in zip(range(rank, len(scenes), mesh.n_parts), got):
                results[i] = out
        return results

    def _predict_batch_local(self, scenes, stacked):
        if stacked:
            try:
                host, orders = self._build_stacked(scenes)
            except ValueError:
                if stacked != "auto":
                    raise
                host = None
            if host is not None:
                out = self._serve(self.place(host), stacked=True)
                out = out.cpu().numpy()
                return [_scene_order(out[i, :s.num_vertices[0]], o)
                        for i, (s, o) in enumerate(zip(scenes, orders))]
        laid = [self._layout(s) for s in scenes]
        out = self._serve(self.place(self._host_graph([s for s, _ in laid])))
        out = out.cpu().numpy()
        results, off = [], 0
        for s, order in laid:
            n = s.num_vertices[0]
            results.append(_scene_order(out[off:off + n], order))
            off += n
        return results

    def predict_partitioned(self, scene: RawHierarchy) -> np.ndarray:
        """Inpaint ONE full (uncropped) scene split across the mesh's
        partitions: vertices owned by coarsest-level ranges
        (graph/partition.py, built on the host), a ring halo exchange of Q
        before each conv (parallel/sharded_stinet.py). Returns
        [num_vertices, output_nc] colors in the scene's vertex order, on
        every rank of a process mesh. Needs a mesh server and an
        instance-norm EdgeConv model without label embedding."""
        pg, info = self.build_partitioned(scene)
        out = self.forward_partitioned(self.place_partitioned(pg))
        return out.cpu().numpy()[info.new_id[0]]

    def build_partitioned(self, scene: RawHierarchy):
        """(partitioned host graph, PartitionInfo): the scene partitioned
        over the mesh (`partition_hierarchy`), without the target colors
        and mask, which the forward does not read."""
        if self.mesh is None:
            raise ValueError("predict_partitioned requires mesh=...")
        from stinet_tpu_torch.graph.partition import partition_hierarchy
        pg, info = partition_hierarchy(scene, self.mesh.n_parts)
        return dataclasses.replace(pg, color=None, mask=None), info

    def place_partitioned(self, pg):
        """The mesh's partitions of this process on the device, in one
        copy (parallel/sharded_stinet.py:place_partitioned)."""
        from stinet_tpu_torch.parallel.sharded_stinet import (
            place_partitioned)
        return place_partitioned(self.mesh, pg, self._placer)

    @torch.inference_mode()
    def forward_partitioned(self, graphs) -> torch.Tensor:
        """The partitioned generator on placed partitions, in f32: every
        partition's [vp0, output_nc] rows in partition order, on every
        rank."""
        if self._sharded_apply is None:
            from stinet_tpu_torch.parallel.sharded_stinet import (
                make_sharded_stinet)
            self._sharded_apply = make_sharded_stinet(self.mesh, self.model,
                                                      self.impl)
        with full_f32_matmuls():
            outs = [o.float() for o in self._sharded_apply(graphs)]
            return self.mesh.gather(outs)

    def predict_stream(self, scenes: Iterable[RawHierarchy]
                       ) -> Iterator[np.ndarray]:
        """Inpaint a stream of scenes as a three-stage pipeline; yields
        each scene's valid-vertex colors in input order.

          stage 1 (thread pool)  host build and width normalization;
          stage 2 (this thread)  pack into the next of INFLIGHT + 1
                                 pinned buffers (after its last copy has
                                 ended), one non-blocking copy to the
                                 device, the forward, and a non-blocking
                                 copy of the output into pinned memory;
          stage 3 (delayed)      wait for scene i's copy back only after
                                 scenes i+1..i+INFLIGHT are dispatched, so
                                 it overlaps their work.

        Stage 1 runs min(4, cpu_count - 1) threads, at least 1: more build
        threads than cores only fight the dispatch thread for the GIL."""
        build_workers = max(1, min(4, (os.cpu_count() or 2) - 1))
        placer = PackedPlacer(self.device, slots=INFLIGHT + 1)
        ex = concurrent.futures.ThreadPoolExecutor(max_workers=build_workers)
        it = iter(scenes)
        pending = collections.deque()    # (scene, future of (graph, order))
        done = collections.deque()   # (host output, event, order) in flight
        end = object()
        stats = self._stream_stats = collections.defaultdict(list)

        def host_prepare(s):
            t0 = time.perf_counter()
            graph, order = self._build_scene(s)
            graph = self._inference_graph(graph)
            stats["build_ms"].append((time.perf_counter() - t0) * 1e3)
            return graph, order

        def submit_next():
            s = next(it, end)
            if s is not end:
                pending.append((s, ex.submit(host_prepare, s)))
            return s is not end

        def dispatch_one():
            s, fut = pending.popleft()
            graph, order = fut.result()
            t0 = time.perf_counter()
            packed = placer.pack(graph)
            t1 = time.perf_counter()
            placed = placer.put(packed)
            t2 = time.perf_counter()
            out = self._serve(placed)[:s.num_vertices[0]]
            done.append((*self._copy_back(out), order))
            stats["pack_ms"].append((t1 - t0) * 1e3)
            stats["wire_mbytes"].append(
                4 * packed.total / 1e6 if packed.total else
                sum(t.nbytes for t in tensor_leaves(graph)) / 1e6)
            stats["put_ms"].append((t2 - t1) * 1e3)
            stats["dispatch_ms"].append((time.perf_counter() - t2) * 1e3)
            submit_next()

        try:
            for _ in range(build_workers + 1):
                if not submit_next():
                    break
            while pending or done:
                while pending and len(done) <= INFLIGHT:
                    dispatch_one()
                host, event, order = done.popleft()
                t0 = time.perf_counter()
                if event is not None:
                    event.synchronize()
                res = _scene_order(host.numpy().copy(), order)
                stats["d2h_wait_ms"].append((time.perf_counter() - t0) * 1e3)
                yield res
        finally:
            ex.shutdown(wait=False, cancel_futures=True)

    def _copy_back(self, out: torch.Tensor):
        """(host tensor, event): a non-blocking copy of `out` into pinned
        memory and the event that marks its end (None on the CPU)."""
        if out.device.type != "cuda":
            return out, None
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def stream_stats(self):
        """Median per-scene phase costs of the last `predict_stream` run:
        host build, pack, the copy's submission (put), forward dispatch,
        the blocking wait for the copy back, and the MB copied. The phases
        overlap in steady state, so the medians do not sum to the time a
        scene takes; they attribute it. Empty before any stream runs."""
        return {k: round(float(np.median(v)), 2)
                for k, v in self._stream_stats.items() if v}

    # -- operations ----------------------------------------------------
    def warmup(self, scenes: Sequence[RawHierarchy],
               batch_sizes: Sequence[int] = (1,), stacked="auto") -> int:
        """Serve every bucket signature the representative `scenes` produce
        once at each batch size, so the kernels are built and loaded, the
        allocator holds its buffers and the running table widths have
        settled before live traffic. At B > 1 with `stacked`, the
        concatenated layout is served too ("auto" falls back to it); at
        B = 1 both `predict` and `predict_batch`. Chunks whose signature
        was already served are skipped. Returns the number of chunks
        served.

        A signature pass over every scene runs first, through the width
        normalization, so the widths grow before anything is served."""
        scenes = list(scenes)
        sigs = {id(s): _signature(self.build(s)) for s in scenes}
        seen = set()
        for b in batch_sizes:
            for i in range(0, max(len(scenes) - b + 1, 1)):
                chunk = scenes[i:i + b]
                if len(chunk) != b:
                    continue
                key = (b, tuple(sigs[id(s)] for s in chunk))
                if key in seen:
                    continue
                seen.add(key)
                if b == 1:
                    self.predict(chunk[0])
                self.predict_batch(chunk, stacked=stacked)
                if stacked and b > 1:
                    self.predict_batch(chunk, stacked=False)
        return len(seen)

    def num_compiles(self) -> int:
        """The number of distinct layouts `predict`, `predict_batch` and
        `predict_stream` have run a forward on: JAX's `num_compiles`, its
        jit caches' sizes, counted the same way (the structure and every
        leaf's shape and dtype; the forward of one graph and of a stacked
        batch apart). Watch it plateau in
        production; a steady climb means the bucket ladder leaks shapes.
        Eager torch compiles nothing; where forwards are captured as CUDA
        graphs, one a bucket, this count is the count of captures."""
        return len(self._served)

    def export(self, scene: RawHierarchy, out_path: str) -> str:
        """Export the forward at this scene's bucket signature (its build,
        widths normalized, on the server's device) with torch.export
        (utils/model_io.py:export_serving); `utils/model_io.py:
        load_serving(out_path)` gives a callable that takes such a graph
        (the leaves `inference_graph` keeps, on this device) and returns
        the f32 output rows in the build's vertex order (a windowed
        build's is the RCM order), without model code. The artifact is
        torch.export's
        format, not the JAX package's StableHLO. An export from a mesh
        server is single-device, as in JAX."""
        from stinet_tpu_torch.utils.model_io import export_serving
        graph = self._inference_graph(self._build_scene(scene)[0])
        return export_serving(_ServedForward(self.model, self.impl),
                              (graph.to(self.device),), out_path)

    # -- construction --------------------------------------------------
    @classmethod
    def from_checkpoint(cls, ckpt_path, example_scene: RawHierarchy,
                        arch_key: Optional[str] = None,
                        arch_overrides: Optional[dict] = None,
                        model_key: str = "graph", **kw):
        """A server for the generator of a port checkpoint
        (core/checkpoint.py): the model rebuilt from the config in its
        meta sidecar, its weights restored, then warmed up on
        `example_scene`.

        The weights are `state_dicts[model_key]`. The arch arguments are
        the config's `archs[arch_key]`; by default `arch_key` is the arch
        the sidecar names for `model_key` (the trainer's checkpoints:
        model "graph", arch "SurfaceTextureInpaintingNet") where the
        config has that entry, else `model_key` itself (a config whose arch
        is named after the model). `arch_overrides` changes arch arguments
        against the training config (e.g. dtype="bfloat16"); `kw` goes to
        the constructor.

        The warmup is kept on purpose: it builds and loads the kernels,
        fills the allocator's caches and settles the table widths before
        the first live request. The JAX server takes `example_scene` for
        its parameter template instead, which a torch model does not
        need."""
        from stinet_tpu_torch.core.checkpoint import load_model_params
        from stinet_tpu_torch.models.factory import define_G
        with open(str(ckpt_path) + ".meta.json") as f:
            meta = json.load(f)
        archs = meta["config"]["archs"]
        if arch_key is None:
            named = meta["archs"].get(model_key)
            arch_key = named if named in archs else model_key
        args = dict(archs[arch_key]["args"])
        args.update(arch_overrides or {})
        server = cls(define_G(**args), load_model_params(ckpt_path, model_key),
                     **kw)
        server.warmup([example_scene])
        return server

"""ucc_tpu_torch — the PyTorch/CUDA port of ucc_tpu, a UCC-style collective
communication framework.

The same layered architecture as the JAX package — lib, context, team,
collective; a score map selecting an algorithm per collective and message
size; collective layers (CL) composing transport layers (TL) — with the
device path in PyTorch and hand-written CUDA kernels for NVIDIA Hopper.
It imports neither JAX nor ``ucc_tpu``.

Ported so far: the core objects, cl/basic; tl/ring_cuda, whose
allreduce, reduce_scatter, allgather, bcast and alltoall run every rank
of an in-process team on one GPU through the kernels of
``kernels/ring_allreduce.py``, ``kernels/ring_rs_ag.py`` and
``kernels/ring_bcast_a2a.py``; tl/self, every collective type on a
1-rank team (and its service team); tl/torch_ops, the default device TL
for every collective type of the JAX package's tl/xla, with its
``xla``, ``ring`` and ``short`` algorithms (library ops over the ranks'
buffers, and, under
``UCC_GEN_DEVICE=y``, the generated device collectives: verified programs
of the collective DSL ``dsl/`` lowered by ``dsl/lower_device.py`` and run
by the kernels of ``kernels/gen_device.py``; ``quant/`` holds the wire
precisions' policy); the execution components ``ec/`` (numpy on
the host, the reduce kernel of ``kernels/ec_reduce.py`` on GPU tensors);
ucc_perftest as ``python -m ucc_tpu_torch.tools.perftest``; and
context-parallel attention: ``fused_attention`` (ring flash-attention over
the ranks' sequence blocks, forward through the kernel of
``kernels/ring_attention.py``, backward by recompute); the in-graph API,
``ops`` over the named axes of a ``mesh.RankMesh`` (collectives through
the library, differentiable, traceable by ``torch.compile``); and the
examples built on it: the long-context MHA and GQA train steps of
``examples/long_context.py``, DP x TP, the pipeline, MoE, and the ring and
Ulysses attentions; and the core's foundations: execution engines and
triggered collectives (``core/ee.py``), sub-teams
(``Team.create_from_parent`` over ``core/oob.SubsetOob``), the runtime
fallback, TL coll plugins, metrics (``obs/metrics.py``) and profiling
(``utils/profiling.py``), pipelined schedules
(``schedule/pipelined.py``) and the host scratch pool (``mc/pool.py``);
and the host transports of one process: tl/shm, which runs the
``tl/host`` algorithm suite (knomial, SRA, ring, DBT, the allgather and
alltoall families; every collective type) on HOST memory (CPU tensors,
numpy arrays) over in-process mailboxes matched by the port's own copy of
the native C++ core (``native.py``, built with g++ into
``ucc_tpu_torch/build/`` on first use), and is the service team of every
multi-rank team of one process, over which the core agrees team ids and
runs the datatype check of rooted collectives
(``UCC_CHECK_ASYMMETRIC_DT=y``); and the host transports across
processes: ``TcpStoreOob`` and ``TcpTreeOob`` bootstrap a job whose
ranks live in several processes, tl/ipc runs the same algorithms through
one host's shared-memory arena (the port's copy of the native arena,
built into the same library) and tl/sockets over TCP, each the service
team of such teams; the one-sided host collectives (sliding-window
allreduce, one-sided alltoall(v)) over ``Context.mem_map`` handles; and
``ucc_perftest --procs``.

Attention on the CPU (the kernel's plain version runs on CPU tensors)::

    import torch
    from ucc_tpu_torch.fused_attention import make_ring_flash_attention
    attn = make_ring_flash_attention(8, causal=True, device="cpu")
    out = attn(torch.randn(32, 64, 16), torch.randn(8, 64, 16),
               torch.randn(8, 64, 16))           # (heads, seq, head_dim)

With the default ``device="cuda"`` it runs on the GPU (and raises without
one); ``kernels.ring_attention.ring_flash_attention_fwd.launches`` counts
the kernel's launches.

Quick start (8 ranks of one GPU; context creation blocks on the OOB
exchange, so each context is created on its own thread)::

    import threading, torch, ucc_tpu_torch as ucc
    n = 8
    world = ucc.ThreadOobWorld(n)
    libs = [ucc.init() for _ in range(n)]
    ctxs = [None] * n
    def make(r):
        ctxs[r] = ucc.Context(libs[r], ucc.ContextParams(oob=world.endpoint(r)))
    threads = [threading.Thread(target=make, args=(r,)) for r in range(n)]
    [t.start() for t in threads]; [t.join() for t in threads]
    tworld = ucc.ThreadOobWorld(n)
    teams = [c.create_team_post(ucc.TeamParams(oob=tworld.endpoint(r)))
             for r, c in enumerate(ctxs)]
    while not all([t.create_test() == ucc.Status.OK for t in teams]):
        [c.progress() for c in ctxs]
    src = [torch.ones(1 << 20, device="cuda") for _ in range(n)]
    dst = [torch.empty_like(s) for s in src]
    reqs = [teams[r].collective_init(ucc.CollArgs(
        coll_type=ucc.CollType.ALLREDUCE, op=ucc.ReductionOp.SUM,
        src=ucc.BufferInfo(src[r], 1 << 20, ucc.DataType.FLOAT32),
        dst=ucc.BufferInfo(dst[r], 1 << 20, ucc.DataType.FLOAT32)))
        for r in range(n)]
    [rq.post() for rq in reqs]
    while any([rq.test() == ucc.Status.IN_PROGRESS for rq in reqs]):
        [c.progress() for c in ctxs]
"""

from .constants import (CollArgsFlags, CollSyncType, CollType,  # noqa: F401
                        DataType, EeType, EventType, MemoryType, ReductionOp,
                        ThreadMode, coll_type_str, dt_size, dt_torch)
from .status import Status, UccError, check  # noqa: F401
from .api.types import (ActiveSet, BufferInfo, BufferInfoV, CollArgs,  # noqa: F401
                        ContextAttr, ContextParams, ContextType, LibAttr, LibParams,
                        OobColl, OobRequest, TeamAttr, TeamParams)
from .core.lib import Lib, init  # noqa: F401
from .core.context import Context  # noqa: F401
from .core.team import Team, TeamState  # noqa: F401
from .core.coll import CollRequest, collective_init  # noqa: F401
from .core.oob import (SubsetOob, TcpStoreOob, TcpTreeOob,  # noqa: F401
                       ThreadOob, ThreadOobWorld, ThreadTreeOobWorld,
                       TreeOob, tree_layout)
from .core.ee import Ee, UccEvent  # noqa: F401

__version__ = "0.1.0"

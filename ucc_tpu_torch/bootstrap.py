"""Multi-process bootstrap: one call makes the TCP store OOBs, a context
per local rank and the world team over every rank of every process.

Environment-driven (the torchrun shape)::

    # per process:  UCC_BOOTSTRAP=host0:29500 UCC_RANK=<proc> UCC_NPROCS=<n>
    #               [UCC_RANKS_PER_PROC=<k>]
    world = ucc_tpu_torch.bootstrap.World.from_env()
    team  = world.team          # spans every rank of every process
    world.finalize()

Explicit::

    world = World(rank=proc_id, nprocs=2, coordinator="host0:29500",
                  ranks_per_proc=4)

Local rank i runs on ``cuda:(i mod torch.cuda.device_count())``, handed
to its context through the device TLs' ``DEVICE`` setting (so on one card
every rank shares ``cuda:0``); ``device="cpu"`` runs the device TLs' plain
versions instead, for tests on a machine without a GPU. There is no
counterpart of the JAX package's ``jax_distributed`` option: the device
TLs need no multi-controller runtime.

Ports: the context store binds the coordinator's port and the team store
the next one; with the tree bootstrap (``UCC_OOB_TREE``) the two trees'
group stores take a block from the port + 3 on.
"""
from __future__ import annotations

import os
import threading
import time
from typing import List

from .status import Status, UccError


def rank_device(device: str, local_rank: int) -> str:
    """The device string of local rank *local_rank*: ``cuda:(i mod the
    device count)`` for ``cuda`` (plain ``cuda`` without a GPU, so that
    the context raises ERR_NO_RESOURCE), else *device* unchanged."""
    if device != "cuda":
        return device
    import torch
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return f"cuda:{local_rank % count}" if count else "cuda"


class World:
    """All ranks of THIS process plus the world team over every process.

    ``ranks_per_proc`` contexts are made; ``self.teams[i]`` /
    ``self.contexts[i]`` are this process's members, ``self.team`` is
    member 0's team for the common one-rank-per-process case.
    """

    def __init__(self, rank: int, nprocs: int,
                 coordinator: str = "127.0.0.1:29500",
                 ranks_per_proc: int = 1, lib_params=None,
                 timeout: float = 120.0, device: str = "cuda"):
        import ucc_tpu_torch as ut
        from .core.oob import (_knob, parse_node_sizes, tree_mode_enabled)

        host, port_s = coordinator.rsplit(":", 1)
        base_port = int(port_s)
        self.proc_rank = rank
        self.nprocs = nprocs
        n = nprocs * ranks_per_proc
        self.world_size = n
        self._oobs: List = []

        # UCC_OOB_TREE=y|n|auto selects the tree-structured store exchange
        # (per-node leader stores, radix-bounded parent stores) over the
        # single flat store; node shape from UCC_OOB_TREE_PPN, else
        # ranks_per_proc, so that each process's ranks share one store
        tree_ppn = parse_node_sizes(_knob("UCC_OOB_TREE_PPN", "")) \
            or ([ranks_per_proc] if ranks_per_proc > 1 else None)
        if tree_mode_enabled(n, host=host):
            tree_ports = ut.TcpTreeOob.ports_needed(n, ppn=tree_ppn)

            def ctx_oob(r):
                return ut.TcpTreeOob(r, n, host=host, base_port=base_port + 3,
                                     key="ucc-ctx", ppn=tree_ppn,
                                     timeout_s=timeout)

            def team_oob(r):
                return ut.TcpTreeOob(r, n, host=host,
                                     base_port=base_port + 3 + tree_ports,
                                     key="ucc-team", ppn=tree_ppn,
                                     timeout_s=timeout)
        else:
            def ctx_oob(r):
                return ut.TcpStoreOob(r, n, host=host, port=base_port)

            def team_oob(r):
                return ut.TcpStoreOob(r, n, host=host, port=base_port + 1)

        my_ranks = [rank * ranks_per_proc + i for i in range(ranks_per_proc)]
        self.libs = [ut.init(lib_params,
                             TL_RING_CUDA_DEVICE=rank_device(device, i))
                     for i in range(ranks_per_proc)]
        self.contexts: List = [None] * ranks_per_proc
        self.teams: List = [None] * ranks_per_proc
        # per-phase error lists: a thread that outlives its join timeout
        # must not have a late exception blamed on the next phase, and a
        # thread still alive after the join IS the error
        ctx_errs: List = []

        def mk(i, r):
            try:
                oob = ctx_oob(r)
                self._oobs.append(oob)
                self.contexts[i] = ut.Context(
                    self.libs[i], ut.ContextParams(oob=oob))
            except Exception as e:  # noqa: BLE001 - re-raised below
                ctx_errs.append(e)

        self._run_threads(mk, my_ranks, timeout, ctx_errs, "context create")
        if any(c is None for c in self.contexts):
            self._teardown_partial()
            raise UccError(Status.ERR_TIMED_OUT,
                           "bootstrap: context create timed out")

        team_errs: List = []

        def mkteam(i, r):
            try:
                oob = team_oob(r)
                self._oobs.append(oob)
                self.teams[i] = self.contexts[i].create_team_post(
                    ut.TeamParams(oob=oob))
            except Exception as e:  # noqa: BLE001 - re-raised below
                team_errs.append(e)

        self._run_threads(mkteam, my_ranks, timeout, team_errs,
                          "team create")
        try:
            if any(t is None for t in self.teams):
                raise UccError(Status.ERR_TIMED_OUT,
                               "bootstrap: team create timed out")
            deadline = time.monotonic() + timeout
            while True:
                sts = [t.create_test() for t in self.teams]
                for c in self.contexts:
                    c.progress()
                if all(s == Status.OK for s in sts):
                    break
                bad = [s for s in sts if s.is_error]
                if bad:
                    raise UccError(bad[0], "bootstrap: team create failed")
                if time.monotonic() > deadline:
                    raise UccError(Status.ERR_TIMED_OUT,
                                   "bootstrap: team create timed out")
        except BaseException:
            self._teardown_partial()
            raise

    def _run_threads(self, fn, my_ranks, timeout, errs, what) -> None:
        ths = [threading.Thread(target=fn, args=(i, r), daemon=True)
               for i, r in enumerate(my_ranks)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=timeout)
        if any(t.is_alive() for t in ths):
            self._teardown_partial()
            raise UccError(Status.ERR_TIMED_OUT,
                           f"bootstrap: {what} timed out (thread still "
                           "running)")
        if errs:
            self._teardown_partial()
            raise errs[0]

    def _teardown_partial(self) -> None:
        """Best-effort destruction of whatever a failed bootstrap made, so
        the caller does not leak listeners or threads."""
        for t in self.teams:
            if t is not None:
                try:
                    t.destroy()
                except Exception:  # noqa: BLE001 - teardown goes on
                    pass
        for c in self.contexts:
            if c is not None:
                try:
                    c.destroy()
                except Exception:  # noqa: BLE001 - teardown goes on
                    pass
        self.teams, self.contexts = [], []
        self._close_oobs()

    def _close_oobs(self) -> None:
        oobs, self._oobs = self._oobs, []
        for oob in oobs:
            try:
                oob.close()
            except Exception:  # noqa: BLE001 - teardown goes on
                pass

    # ------------------------------------------------------------------
    @property
    def team(self):
        return self.teams[0]

    @property
    def context(self):
        return self.contexts[0]

    def progress(self) -> None:
        for c in self.contexts:
            c.progress()

    def finalize(self) -> None:
        for t in self.teams:
            if t is not None:
                t.destroy()
        for c in self.contexts:
            if c is not None:
                c.destroy()
        self.teams, self.contexts = [], []
        self._close_oobs()

    # ------------------------------------------------------------------
    @classmethod
    def from_env(cls, **kw) -> "World":
        """torchrun-style: UCC_BOOTSTRAP=host:port UCC_RANK UCC_NPROCS
        [UCC_RANKS_PER_PROC]; keyword arguments win."""
        coord = os.environ.get("UCC_BOOTSTRAP", "127.0.0.1:29500")
        rank = int(os.environ.get("UCC_RANK", "0"))
        nprocs = int(os.environ.get("UCC_NPROCS", "1"))
        kw.setdefault("ranks_per_proc",
                      int(os.environ.get("UCC_RANKS_PER_PROC", "1")))
        return cls(rank=rank, nprocs=nprocs, coordinator=coord, **kw)

"""ucc_info: introspection CLI.

The counterpart of UCC's ``tools/info/ucc_info.c``::

    python -m ucc_tpu_torch.tools.info -v      # version, components, card
    python -m ucc_tpu_torch.tools.info -cf     # every config variable
    python -m ucc_tpu_torch.tools.info -s [N]  # score map of a probe team
    python -m ucc_tpu_torch.tools.info -A      # per-TL algorithm lists
    python -m ucc_tpu_torch.tools.info -c      # capability lists

The device TLs (tl/ring_cuda, tl/torch_ops) probe the device that their
``UCC_TL_RING_CUDA_DEVICE`` names (``cuda``, that is ``cuda:0``, by
default). Where that device is missing, ``-v``, ``-s`` and ``-c`` show
them as unavailable and the probe team is made without them; no CPU
device stands in for the card unless the variable asks for ``cpu``.
``-s N`` with N > 1 makes an in-process N-rank probe job, so the rows
that only multi-rank teams have show, e.g. cl/hier's under
``UCC_TOPO_FAKE_PPN=2``: ``ucc_info -s 4``.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Tuple

import ucc_tpu_torch
from ucc_tpu_torch.constants import (COLL_TYPE_LIST, DataType, MemoryType,
                                     ReductionOp, coll_type_str)
from ucc_tpu_torch.core.components import (available_cls, available_tls,
                                           discover_components, get_tl)
from ucc_tpu_torch.utils.config import registered_tables


def device_tls() -> List[str]:
    """The TLs whose contexts claim a device (tl/device.TlDeviceContext)."""
    from ucc_tpu_torch.tl.device import TlDeviceContext
    out = []
    for name in available_tls():
        ctx_cls = getattr(get_tl(name), "context_cls", None)
        if isinstance(ctx_cls, type) and issubclass(ctx_cls, TlDeviceContext):
            out.append(name)
    return out


def device_probe() -> Tuple[Optional[str], str]:
    """(device, description) of the device the device TLs would claim:
    device is None when it is unavailable, and the description says
    why."""
    from ucc_tpu_torch.status import UccError
    from ucc_tpu_torch.tl.device import DEVICE_CONFIG, resolve_device
    from ucc_tpu_torch.utils.config import Config
    try:
        spec = str(Config(DEVICE_CONFIG).device)
        dev = resolve_device(spec)
    except UccError as e:
        return None, f"unavailable ({e})"
    if dev.type == "cuda":
        import torch
        return str(dev), f"{dev} ({torch.cuda.get_device_name(dev)})"
    return str(dev), f"{dev} (the plain versions of the kernels)"


def print_version() -> None:
    print(f"# UCC-TPU-torch version {ucc_tpu_torch.__version__}")
    print("#  collective communication framework, PyTorch and CUDA")
    print(f"#  CLs: {', '.join(available_cls())}")
    print(f"#  TLs: {', '.join(available_tls())}")
    try:
        import torch
        cuda = torch.version.cuda or "none"
        print(f"#  torch {torch.__version__}, CUDA {cuda}")
    except Exception:  # noqa: BLE001
        print("#  torch: unavailable")
    _, desc = device_probe()
    print(f"#  device TLs ({', '.join(device_tls())}): {desc}")


def _register_all_tables() -> None:
    """Import every module that registers a config table."""
    discover_components()
    import ucc_tpu_torch.core.lib  # noqa: F401 - the global table
    import ucc_tpu_torch.integrity  # noqa: F401
    import ucc_tpu_torch.mc.pool  # noqa: F401
    import ucc_tpu_torch.native  # noqa: F401
    import ucc_tpu_torch.obs  # noqa: F401
    import ucc_tpu_torch.tl.device  # noqa: F401


def print_config() -> None:
    _register_all_tables()
    for name, table in sorted(registered_tables().items()):
        print(f"#\n# {name or 'global'}\n#")
        for f in table.fields:
            env = table.field_env_name(f)
            print(f"{env}={f.default}")
            if f.doc:
                print(f"#   {f.doc}")


def print_algorithms() -> None:
    discover_components()
    print("# per-TL algorithm lists (@id or @name usable in UCC_TL_X_TUNE)")
    for tl_name in available_tls():
        tl = get_tl(tl_name)
        print(f"\ncl/basic tl/{tl_name}:")
        team_cls = tl.team_cls
        if not hasattr(team_cls, "alg_table") or tl_name == "self":
            for c in COLL_TYPE_LIST:
                if c & tl.SUPPORTED_COLLS:
                    print(f"  {coll_type_str(c)}: 0: direct")
            continue
        # instantiate nothing: read the table through a stub
        try:
            stub = object.__new__(team_cls)
            stub.TL_CLS = tl
            table = team_cls.alg_table(stub)
            for coll, specs in sorted(table.items()):
                algs = " ".join(f"{s.id}:{s.name}" for s in specs)
                print(f"  {coll_type_str(coll)}: {algs}")
        except Exception:  # noqa: BLE001 - the table needs a live team
            for c in COLL_TYPE_LIST:
                if c & tl.SUPPORTED_COLLS:
                    print(f"  {coll_type_str(c)}: (runtime)")


def _probe_tls() -> Optional[str]:
    """The TLS override of a probe lib: None when the device TLs' device
    is there, else every TL but the device ones (after any UCC_TLS)."""
    dev, desc = device_probe()
    if dev is not None:
        return None
    from ucc_tpu_torch.utils.config import Config
    from ucc_tpu_torch.core.lib import GLOBAL_CONFIG
    try:
        allowed = [t.strip() for t in Config(GLOBAL_CONFIG).tls]
    except Exception:  # noqa: BLE001 - an unreadable list: every TL
        allowed = ["all"]
    names = available_tls() if "all" in allowed else \
        [t for t in allowed if t in available_tls()]
    dev_tls = device_tls()
    print(f"# device TLs {', '.join(dev_tls)}: {desc}; the probe team is "
          f"made without them")
    return ",".join(t for t in names if t not in dev_tls)


def print_scores(team_size: int = 1) -> None:
    """Default score map of a probe team (UCC prints it at team create;
    ``-s`` does it alone). ``team_size > 1`` makes an in-process
    multi-rank job over a thread OOB, so the rows that need more than one
    rank show, e.g. cl/hier's, which need a node/net split:
    ``UCC_TOPO_FAKE_PPN=2 ucc_info -s 4``."""
    tls = _probe_tls()
    overrides = {} if tls is None else {"TLS": tls}
    if team_size <= 1:
        lib = ucc_tpu_torch.init(**overrides)
        ctx = ucc_tpu_torch.Context(lib)
        team = ctx.create_team(ucc_tpu_torch.TeamParams())
        print(team.score_map.print_info("probe team (size 1)"))
        team.destroy()
        ctx.destroy()
        return

    import threading
    import time

    from ucc_tpu_torch import (ContextParams, Status, TeamParams,
                               ThreadOobWorld)
    n = team_size
    world = ThreadOobWorld(n)
    libs = [ucc_tpu_torch.init(**overrides) for _ in range(n)]
    ctxs: list = [None] * n
    errs: list = []

    def mk(r):
        try:
            ctxs[r] = ucc_tpu_torch.Context(
                libs[r], ContextParams(oob=world.endpoint(r)))
        except Exception as e:  # noqa: BLE001 - reported below
            errs.append((r, e))

    ths = [threading.Thread(target=mk, args=(r,)) for r in range(n)]
    for t in ths:
        t.start()
    for t in ths:
        t.join()
    if errs:
        raise RuntimeError(f"probe context create failed: {errs}")
    tw = ThreadOobWorld(n)
    teams = [c.create_team_post(TeamParams(oob=tw.endpoint(i)))
             for i, c in enumerate(ctxs)]
    deadline = time.monotonic() + 60
    while True:
        sts = [t.create_test() for t in teams]
        for c in ctxs:
            c.progress()
        if all(s == Status.OK for s in sts):
            break
        bad = [s for s in sts if s.is_error]
        if bad:
            raise RuntimeError(f"probe team create failed: {bad}")
        if time.monotonic() > deadline:
            raise RuntimeError("probe team create timed out (60s)")
    print(teams[0].score_map.print_info(f"probe team (size {n})"))
    # the hierarchy cl/hier derived from the (possibly faked) topology,
    # beside the rows, so a mis-detected layout shows here instead of
    # running flat unseen: `UCC_TOPO_FAKE_PPN=2
    # UCC_TOPO_FAKE_NODES_PER_POD=2 ucc_info -s 8`
    for cl in teams[0].cl_teams:
        describe = getattr(cl, "describe_topology", None)
        if describe is not None:
            print(f"# resolved {cl.name} hierarchy:")
            print(describe())
    for t in teams:
        t.destroy()
    for c in ctxs:
        c.destroy()


def print_caps() -> None:
    print("# collective types:", ", ".join(coll_type_str(c)
                                           for c in COLL_TYPE_LIST))
    print("# memory types:", ", ".join(m.name.lower()
                                       for m in (MemoryType.HOST,
                                                 MemoryType.CUDA)))
    _, desc = device_probe()
    print(f"# cuda memory device: {desc}")
    print("# datatypes:", ", ".join(d.name.lower() for d in DataType))
    print("# reduction ops:", ", ".join(o.name.lower()
                                        for o in ReductionOp))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ucc_info")
    p.add_argument("-v", "--version", action="store_true")
    p.add_argument("-cf", "--config", action="store_true",
                   help="print all config variables")
    p.add_argument("-s", "--scores", nargs="?", const=1, type=int,
                   default=None, metavar="N",
                   help="print default score map (optional N = probe "
                        "team size; N>1 shows multi-rank-only rows, "
                        "e.g. CL/HIER under UCC_TOPO_FAKE_PPN)")
    p.add_argument("-A", "--algorithms", action="store_true",
                   help="print per-TL algorithm lists")
    p.add_argument("-c", "--caps", action="store_true",
                   help="print capability matrix")
    args = p.parse_args(argv)
    if args.scores is not None and args.scores < 1:
        p.error("-s team size must be >= 1")
    if not any(v not in (None, False) for v in vars(args).values()):
        args.version = True
    if args.version:
        print_version()
    if args.caps:
        print_caps()
    if args.config:
        print_config()
    if args.algorithms:
        print_algorithms()
    if args.scores is not None:
        print_scores(args.scores)
    return 0


if __name__ == "__main__":
    sys.exit(main())

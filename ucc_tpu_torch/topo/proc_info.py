"""Process and topology identity (UCC's ``ucc_proc_info_t``: host hash,
socket, NUMA node and pid, gathered context-wide during the address
exchange), plus the simulated-topology knobs.

Two host identities travel side by side: ``host_hash`` is the TOPOLOGY
identity, which ``UCC_TOPO_FAKE_PPN`` rewrites to simulate multi-node
teams, and ``real_host_hash`` the physical one. The device rendezvous does
not read either: the context keeps the physical ``(hostname, pid)`` as
``Context.proc`` for it, so the fake topology never splits a device team.
"""
from __future__ import annotations

import os
import socket as _socket
import zlib
from dataclasses import dataclass


@dataclass(frozen=True)
class ProcInfo:
    host_hash: int
    pid: int
    socket_id: int = 0
    numa_id: int = 0
    #: physical host identity; -1 = same as host_hash
    real_host_hash: int = -1
    #: pod identity (a group of hosts behind one inter-pod network);
    #: -1 = unknown, and ranks of unknown pod count as one pod, so the
    #: hierarchy degrades to the classic node/leaders split. From
    #: UCC_POD_ID (set by the launcher) or the fake-topology knobs.
    pod_hash: int = -1

    def same_host(self, other: "ProcInfo") -> bool:
        return self.host_hash == other.host_hash

    @property
    def phys_host_hash(self) -> int:
        return self.real_host_hash if self.real_host_hash != -1 \
            else self.host_hash


def host_hash(name: str = "") -> int:
    name = name or _socket.gethostname()
    return zlib.crc32(name.encode())


def fake_topology(rank: int, env=None):
    """The simulated-topology knobs, resolved for one context rank.

    ``UCC_TOPO_FAKE_PPN`` groups ranks into virtual nodes: one int N
    (nodes of N) or a comma list of node sizes applied cyclically
    (``"2,1,3"`` -> nodes of 2,1,3,2,1,3,...) for asymmetric layouts.
    ``UCC_TOPO_FAKE_NODES_PER_POD`` groups every M consecutive virtual
    nodes into a pod (the 3-level layout). Returns ``(node_idx,
    pod_idx)``; each is None when its knob is unset or malformed (then
    the real host detection applies; ``core/oob.parse_node_sizes`` shares
    the grammar)."""
    env = os.environ if env is None else env
    spec = env.get("UCC_TOPO_FAKE_PPN", "").strip()
    if not spec:
        return None, None
    try:
        sizes = [max(1, int(tok)) for tok in spec.split(",")
                 if tok.strip()]
    except ValueError:
        return None, None
    if not sizes:
        return None, None
    cycle = sum(sizes)
    node = (rank // cycle) * len(sizes)
    off = rank % cycle
    for s in sizes:
        if off < s:
            break
        off -= s
        node += 1
    npp = env.get("UCC_TOPO_FAKE_NODES_PER_POD", "").strip()
    pod = None
    if npp:
        try:
            pod = node // max(1, int(npp))
        except ValueError:
            pod = None
    return node, pod


def fake_node_hash(node: int) -> int:
    """The topology host hash of virtual node *node*."""
    return zlib.crc32(f"fake-node-{node}".encode())


def fake_pod_hash(pod: int) -> int:
    """The pod hash of virtual pod *pod*."""
    return zlib.crc32(f"fake-pod-{pod}".encode())


def local_proc_info() -> ProcInfo:
    """This process's identity: the host name's hash, the pid and the
    pod named by ``UCC_POD_ID``."""
    hh = host_hash()
    pod = os.environ.get("UCC_POD_ID", "")
    ph = host_hash(f"pod-{pod}") if pod else -1
    return ProcInfo(host_hash=hh, pid=os.getpid(), real_host_hash=hh,
                    pod_hash=ph)


def context_proc_info(rank: int, env=None) -> ProcInfo:
    """The ProcInfo a context of rank *rank* publishes: the local one with
    the fake-topology knobs applied to the topology identity only
    (``host_hash`` and ``pod_hash``; ``real_host_hash`` stays physical)."""
    info = local_proc_info()
    node, pod = fake_topology(rank, env)
    if node is None:
        return info
    import dataclasses
    repl = {"host_hash": fake_node_hash(node)}
    if pod is not None:
        repl["pod_hash"] = fake_pod_hash(pod)
    return dataclasses.replace(info, **repl)

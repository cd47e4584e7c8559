"""Topology: process identity, subgroups and the hierarchy tree."""
from .proc_info import ProcInfo, local_proc_info  # noqa: F401
from .topo import ContextTopo, HierTree, TeamTopo  # noqa: F401
from .sbgp import Sbgp, SbgpType, SbgpStatus  # noqa: F401

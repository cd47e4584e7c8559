"""A TL coll plugin outside the package, for tests/test_torch_core_coll.py:
adds an allreduce algorithm ("dummy") to tl/torch_ops through
UCC_TL_TORCH_OPS_COLL_PLUGINS, selectable through the TUNE string. It
delegates the work to tl/torch_ops's library-ops task and counts its
inits, so a test can show that the plugin's path ran."""

from ucc_tpu_torch.constants import CollType
from ucc_tpu_torch.tl.base import AlgSpec
from ucc_tpu_torch.tl.torch_ops import TorchOpsCollTask

INIT_CALLS = 0


def ucc_coll_plugin(tl_team):
    def init(ia, team):
        global INIT_CALLS
        INIT_CALLS += 1
        return TorchOpsCollTask(ia, team, "xla")

    return {CollType.ALLREDUCE: [AlgSpec(100, "dummy", init)]}

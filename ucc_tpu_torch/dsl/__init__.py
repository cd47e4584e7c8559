"""The collective compiler's device half (the port of ``ucc_tpu/dsl``):
the program IR and its builder (``ir``), the static verifier (``verify``),
the built-in families (``families``), the verified-program cache
(``registry``) and the lowering of programs to generated device
collectives (``lower_device``). The host half (compile, native plans,
search, the disk cache) is not ported yet."""
from .ir import DSL_VERSION, Op, OpKind, Program, ProgramBuilder  # noqa: F401
from .verify import VerifyError, verify  # noqa: F401

"""Config fields shared by every host-algorithm TL (the port of the JAX
package's ``tl/host/config_fields.py``, with the same knob names).

The algorithm-tuning knobs are defined once here and extended with
per-transport fields in the TL modules (tl/shm: EAGER_THRESH, NATIVE).
ConfigField instances are immutable descriptors; the env-var prefix comes
from the owning table (``UCC_TL_SHM_ALLREDUCE_KN_RADIX``). The one-sided
knobs are listed for the algorithms that read them in a later slice.
"""
from __future__ import annotations

from ...utils.config import (ConfigField, parse_bool, parse_memunits,
                             parse_mrange_uint, parse_string, parse_uint,
                             parse_uint_auto)

HOST_ALG_FIELDS = [
    ConfigField("RANKS_REORDERING", "y", "reorder ranks so ring "
                "neighbors are host-local on multi-node teams "
                "(FULL_HOST_ORDERED sbgp; reference RANKS_REORDERING)",
                parse_bool),
    ConfigField("KN_RADIX", "0", "convenience override: a positive "
                "value supersedes the barrier/bcast/reduce KN radixes "
                "(reference KN_RADIX, tl_ucp_lib.c:30-37; allreduce "
                "keeps its own knob; this build's reduce_scatter/"
                "scatter/gather trees are binomial, radix fixed at 2)",
                parse_uint),
    ConfigField("ALLREDUCE_KN_RADIX", "0-inf:4",
                "allreduce knomial radix per msg range", parse_mrange_uint),
    ConfigField("ALLREDUCE_SRA_RADIX", "0-inf:auto", "SRA allreduce "
                "scatter-reduce-allgather radix per msg range "
                "(auto = 2, the canonical halving instance)",
                parse_mrange_uint),
    ConfigField("ALLREDUCE_SRA_PIPELINE", "n", "fragmentation pipeline "
                "spec for SRA allreduce (reference "
                "ALLREDUCE_SRA_KN_PIPELINE), e.g. "
                "thresh=64K:fragsize=1M:nfrags=4:pdepth=2:ordered; n = off",
                parse_string),
    ConfigField("REDUCE_SRG_RADIX", "0-inf:auto", "SRG reduce "
                "scatter-reduce-gather radix per msg range (auto = 2)",
                parse_mrange_uint),
    ConfigField("REDUCE_SRG_PIPELINE", "n", "fragmentation pipeline "
                "spec for SRG reduce (reference REDUCE_SRG_KN_PIPELINE); "
                "same DSL as ALLREDUCE_SRA_PIPELINE; n = off",
                parse_string),
    ConfigField("BCAST_KN_RADIX", "0-inf:4", "bcast tree radix",
                parse_mrange_uint),
    ConfigField("REDUCE_KN_RADIX", "0-inf:4", "reduce tree radix",
                parse_mrange_uint),
    ConfigField("BARRIER_KN_RADIX", "0-inf:4",
                "barrier dissemination radix", parse_mrange_uint),
    ConfigField("ALLTOALL_PAIRWISE_NUM_POSTS", "auto", "max in-flight "
                "pairwise alltoall exchanges (reference "
                "ALLTOALL_PAIRWISE_NUM_POSTS); auto = 1 for >64KB on "
                ">32-rank teams else all; 0 = all", parse_uint_auto),
    ConfigField("ALLTOALLV_PAIRWISE_NUM_POSTS", "auto", "max in-flight "
                "pairwise alltoallv exchanges; auto = 1 on >32-rank "
                "teams else all (team-size-only, "
                "alltoallv_pairwise.c:30-46); 0/inf = all",
                parse_uint_auto),
    ConfigField("ALLGATHER_BATCHED_NUM_POSTS", "auto", "max in-flight "
                "sends/recvs of the allgather linear_batched algorithm "
                "(reference ALLGATHER_BATCHED_NUM_POSTS); auto = team "
                "size - 1 (one-shot)", parse_uint_auto),
    ConfigField("ALLTOALLV_HYBRID_CHUNK_BYTE_LIMIT", "12k", "per-pair "
                "byte bound under which hybrid alltoallv aggregates "
                "messages through the forwarding phase (reference "
                "ALLTOALLV_HYBRID_CHUNK_BYTE_LIMIT)", parse_memunits),
    ConfigField("ALLTOALLV_HYBRID_PAIRWISE_NUM_POSTS", "3", "in-flight "
                "bound of hybrid alltoallv's direct (large-pair) phase "
                "(reference default 3)", parse_uint_auto),
    ConfigField("GATHERV_LINEAR_NUM_POSTS", "0", "root-side in-flight "
                "recv bound for linear gather(v) (reference "
                "GATHERV_LINEAR_NUM_POSTS); 0 = all at once",
                parse_uint_auto),
    ConfigField("SCATTERV_LINEAR_NUM_POSTS", "16", "root-side in-flight "
                "send bound for linear scatter(v) (reference "
                "SCATTERV_LINEAR_NUM_POSTS default 16); 0 = all",
                parse_uint_auto),
    ConfigField("ALLTOALL_ONESIDED_ALG", "put", "one-sided alltoall "
                "variant: put (counter completion) | get (barrier)",
                parse_string),
    ConfigField("ALLTOALLV_ONESIDED_ALG", "put", "one-sided alltoallv "
                "variant: put (counter completion; reference parity) | "
                "get (barrier; beyond-reference)", parse_string),
    ConfigField("ALLREDUCE_SW_WINDOW", "auto", "sliding-window "
                "allreduce window bytes; auto = max(256K, min(1M, "
                "msg/64)) from the round-5 pipelined TCP re-sweep "
                "(BASELINE.md)", parse_memunits),
    ConfigField("ALLREDUCE_SW_INFLIGHT", "auto", "sliding-window "
                "allreduce in-flight get buffers (reference "
                "num_buffers, allreduce_sliding_window.h:36-38); "
                "auto = 4 — depth stopped mattering once windows "
                "pipeline across the message (round-5 re-sweep)",
                parse_uint_auto),
]

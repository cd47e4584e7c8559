"""CL/BASIC — pass-through collective layer (UCC's cl/basic).

Builds one team per available TL and merges their scores into the CL
team's score map; coll dispatch is a score-map lookup over the TLs. TL
team-create failures are tolerated as long as at least one TL team exists.
"""
from __future__ import annotations

from typing import List

from ..core.components import (BaseContext, BaseLib, BaseTeam,
                               CollectiveLayer, register_cl)
from ..score.score import CollScore
from ..status import Status, UccError
from ..utils.config import ConfigField, ConfigTable, parse_list, register_table
from ..utils.log import get_logger

logger = get_logger("cl_basic")

CL_BASIC_CONFIG = register_table(ConfigTable(
    prefix="CL_BASIC_", name="cl/basic", fields=[
        ConfigField("TLS", "all", "TLs cl/basic may use", parse_list),
    ]))


class ClBasicTeam(BaseTeam):
    NAME = "basic"

    def __init__(self, comp_context: BaseContext, core_team):
        super().__init__(comp_context, core_team)
        self.tl_teams: List = []
        self._pending: List = []
        allow = comp_context.config.tls if comp_context.config else ["all"]
        ctx = comp_context.core_context
        for name, handle in ctx.tl_contexts.items():
            if allow != ["all"] and name not in allow:
                continue
            tl_cls = handle.tl_lib.tl_cls
            try:
                self._pending.append(tl_cls.team_cls(handle.obj, core_team,
                                                     scope="cl_basic"))
            except UccError as e:
                logger.debug("tl %s team skipped: %s", name, e)

    def create_test(self) -> Status:
        still = []
        for t in self._pending:
            st = t.create_test()
            if st == Status.IN_PROGRESS:
                still.append(t)
            elif st.is_error:
                logger.debug("tl %s team create failed: %s", t.name, st)
                t.destroy()
            else:
                self.tl_teams.append(t)
        self._pending = still
        if still:
            return Status.IN_PROGRESS
        if not self.tl_teams:
            return Status.ERR_NO_RESOURCE
        return Status.OK

    def get_scores(self) -> CollScore:
        merged = CollScore()
        for t in self.tl_teams:
            merged = merged.merge(t.get_scores())
        return merged

    def destroy(self) -> None:
        for t in self.tl_teams + self._pending:
            t.destroy()


class ClBasicContext(BaseContext):
    pass


@register_cl
class ClBasic(CollectiveLayer):
    NAME = "basic"
    DEFAULT_SCORE = 20
    CONTEXT_CONFIG = CL_BASIC_CONFIG
    lib_cls = BaseLib
    context_cls = ClBasicContext
    team_cls = ClBasicTeam

"""The port's PipelinedSchedule against the JAX package's: the cases of
tests/test_schedule.py's TestPipelined and TestPipelineParams run on
both with recording tasks, and the sequences of (event, task, fragment)
must be equal."""
import pytest

pytest.importorskip("jax")

from ucc_tpu.schedule import pipelined as jpipe  # noqa: E402
from ucc_tpu.schedule import progress as jprogress  # noqa: E402
from ucc_tpu.schedule import schedule as jschedule  # noqa: E402
from ucc_tpu.schedule import task as jtask  # noqa: E402
from ucc_tpu.status import Status as JStatus  # noqa: E402
from ucc_tpu_torch.schedule import pipelined as tpipe  # noqa: E402
from ucc_tpu_torch.schedule import progress as tprogress  # noqa: E402
from ucc_tpu_torch.schedule import schedule as tschedule  # noqa: E402
from ucc_tpu_torch.schedule import task as ttask  # noqa: E402
from ucc_tpu_torch.status import Status as TStatus  # noqa: E402


class _Pkg:
    def __init__(self, task, schedule, pipe, progress, status):
        self.task, self.schedule, self.pipe = task, schedule, pipe
        self.progress, self.Status = progress, status

        class FragTask(task.CollTask):
            """Completes after n_steps progress calls; records its post,
            its completion and its fragment; fails on frag `fail_on`."""

            def __init__(self, name, trace, n_steps=2, fail_on=None):
                super().__init__()
                self.name, self.trace = name, trace
                self.n_steps, self.steps = n_steps, 0
                self.fail_on = fail_on
                self.frag_num = -1

            def post_fn(self):
                self.trace.append(("post", self.name, self.frag_num))
                self.steps = 0
                return status.OK

            def progress_fn(self):
                self.steps += 1
                if self.steps >= self.n_steps:
                    if self.frag_num == self.fail_on:
                        self.status = status.ERR_NO_MESSAGE
                    else:
                        self.trace.append(("done", self.name,
                                           self.frag_num))
                        self.status = status.OK

        self.FragTask = FragTask


JAX = _Pkg(jtask, jschedule, jpipe, jprogress, JStatus)
TORCH = _Pkg(ttask, tschedule, tpipe, tprogress, TStatus)


def make_pipeline(pkg, trace, n_frags, n_frags_total, order,
                  tasks_per_frag=2, steps=2, fail_on=None):
    def frag_init(sched, idx):
        frag = pkg.schedule.Schedule()
        for j in range(tasks_per_frag):
            t = pkg.FragTask(f"w{idx}.t{j}", trace, n_steps=steps + j,
                             fail_on=fail_on)
            frag.add_task(t)
            frag.add_dep_on_schedule_start(t)
        return frag

    def frag_setup(sched, frag, frag_num):
        for t in frag.tasks:
            t.frag_num = frag_num
            trace.append(("setup", t.name, frag_num))
        return pkg.Status.OK

    return pkg.pipe.PipelinedSchedule(
        frag_init=frag_init, frag_setup=frag_setup, n_frags=n_frags,
        n_frags_total=n_frags_total,
        order=pkg.pipe.PipelineOrder[order])


def drive(pkg, pq, task, max_iters=2000):
    it = 0
    while not task.is_completed():
        pq.progress()
        it += 1
        assert it < max_iters, "progress did not converge"
    return task.super_status.name


def run(pkg, posts=1, **kw):
    """The trace and end status of each post of one pipelined schedule."""
    pq = pkg.progress.ProgressQueue()
    trace = []
    sched = make_pipeline(pkg, trace, **kw)
    sched.progress_queue = pq
    out = []
    for _ in range(posts):
        sched.post()
        out.append(drive(pkg, pq, sched))
        out.append([tuple(e) for e in trace])
        trace.clear()
        sched.reset()
    return out


CASES = {
    # TestPipelined: every order, 2 of 5 fragments in flight
    **{f"all_fragments_run_{o.lower()}": dict(
        n_frags=2, n_frags_total=5, order=o)
       for o in ("PARALLEL", "ORDERED", "SEQUENTIAL")},
    "sequential_order_strict": dict(n_frags=2, n_frags_total=4,
                                    order="SEQUENTIAL", tasks_per_frag=1),
    "window_smaller_than_total": dict(n_frags=3, n_frags_total=10,
                                      order="ORDERED"),
    "single_frag": dict(n_frags=4, n_frags_total=1, order="SEQUENTIAL"),
    # beyond them: the window cap, unequal task lengths, a re-post
    "window_capped_at_max_frags": dict(n_frags=9, n_frags_total=12,
                                       order="PARALLEL", steps=1),
    "three_tasks_sequential_reposted": dict(
        n_frags=3, n_frags_total=7, order="SEQUENTIAL", tasks_per_frag=3,
        posts=2),
    "ordered_reposted": dict(n_frags=2, n_frags_total=6, order="ORDERED",
                             posts=3),
    **{f"error_on_frag_3_{o.lower()}": dict(
        n_frags=2, n_frags_total=6, order=o, fail_on=3)
       for o in ("PARALLEL", "ORDERED", "SEQUENTIAL")},
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_pipeline_same_events(name):
    kw = dict(CASES[name])
    want = run(JAX, **kw)
    got = run(TORCH, **kw)
    assert got == want
    statuses = got[0::2]
    if "fail_on" in kw:
        assert statuses == ["ERR_NO_MESSAGE"]
    else:
        assert set(statuses) == {"OK"}
        total = kw["n_frags_total"] * kw.get("tasks_per_frag", 2)
        for trace in got[1::2]:
            assert len([e for e in trace if e[0] == "done"]) == total
            assert sorted({e[2] for e in trace if e[0] == "setup"}) == \
                list(range(kw["n_frags_total"]))


def test_sequential_posts_after_done():
    """TestPipelined.test_sequential_order_strict's check on the port: with
    one task a fragment, done(frag k) comes before post(frag k+1)."""
    trace = run(TORCH, n_frags=2, n_frags_total=4, order="SEQUENTIAL",
                tasks_per_frag=1)[1]
    evs = [e for e in trace if e[0] in ("post", "done")]
    assert [e[0] for e in evs] == ["post", "done"] * 4
    assert [e[2] for e in evs] == [0, 0, 1, 1, 2, 2, 3, 3]


@pytest.mark.parametrize("spec", [
    "", "n", "auto", "thresh=64K:fragsize=1M:nfrags=4:pdepth=2:ordered",
    "threshold=1k:frag_size=512:n_frags=3:depth=5:parallel",
    "fragsize=inf:sequential", "thresh=0", "pdepth=1:nfrags=1"])
def test_parse_pipeline_params(spec):
    want = jpipe.parse_pipeline_params(spec)
    got = tpipe.parse_pipeline_params(spec)
    assert (got.threshold, got.frag_size, got.n_frags, got.pdepth,
            int(got.order)) == (want.threshold, want.frag_size,
                                want.n_frags, want.pdepth, int(want.order))
    for msgsize in (0, 1000, 1 << 16, (1 << 16) + 1, 10 << 20, 1 << 30):
        assert got.nfrags_pdepth(msgsize) == want.nfrags_pdepth(msgsize)


@pytest.mark.parametrize("spec", ["bogus=1", "nfrags", "fragsize=12q"])
def test_parse_pipeline_params_rejects(spec):
    for mod in (jpipe, tpipe):
        with pytest.raises(ValueError):
            mod.parse_pipeline_params(spec)

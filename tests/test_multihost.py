"""Multi-host training integration test (SURVEY.md §7 layer 6).

Launches TWO real OS processes connected through
``jax.distributed.initialize`` (gloo CPU collectives) running the train
CLI with ``--coordinatorAddress``, and checks the trained model equals a
single-process run on a 2-virtual-device mesh: identical sharding layout
(B rows split over 2 data-axis shards, psum of 2 partials) means the
floating-point reduction tree is the same, so the parameters must match
to the last ulp."""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from tehmm_tpu.io import write_bed_intervals


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture
def fixture(tmp_path):
    rng = np.random.RandomState(7)
    L = 1200
    truth = np.zeros(L, dtype=int)
    for s in range(100, L - 100, 400):
        truth[s : s + 120] = 1
    rows = []
    pos = 0
    while pos < L:
        end = min(pos + rng.randint(15, 40), L)
        is_te = truth[pos:end].mean() > 0.5
        val = "X" if rng.rand() < (0.85 if is_te else 0.1) else "Y"
        rows.append(("chr1", pos, end, val))
        pos = end
    bed_a = str(tmp_path / "a.bed")
    write_bed_intervals(rows, bed_a)
    xml = tmp_path / "tracks.xml"
    xml.write_text(
        "<teModelConfig>\n"
        f'  <track name="a" path="{bed_a}"/>\n'
        "</teModelConfig>\n"
    )
    regions = str(tmp_path / "regions.bed")
    write_bed_intervals([("chr1", 0, L)], regions)
    return dict(dir=tmp_path, xml=str(xml), regions=regions)


_RUNNER = textwrap.dedent(
    """
    import json, sys
    from tehmm_tpu.cli import train
    raise SystemExit(train.main(json.loads(sys.argv[1])))
    """
)


def _launch(args, extra_env=None):
    env = dict(os.environ)
    env["TEHMM_PLATFORM"] = "cpu"
    env.pop("XLA_FLAGS", None)
    env["TEHMM_COMPILE_CACHE"] = "0"
    if extra_env:
        env.update(extra_env)
    import json

    return subprocess.Popen(
        [sys.executable, "-c", _RUNNER, json.dumps(args)],
        env=env,
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
    )


TRAIN_ARGS = ["--numStates", "2", "--iter", "5", "--seed", "3",
              "--chunk", "256"]


class TestTwoProcessTraining:
    def test_two_process_em_matches_single(self, fixture):
        f = fixture
        port = _free_port()
        m2 = str(f["dir"] / "model_2proc.npz")
        procs = [
            _launch(
                [f["xml"], f["regions"], m2] + TRAIN_ARGS
                + ["--coordinatorAddress", f"localhost:{port}",
                   "--numProcesses", "2", "--processId", str(i)]
            )
            for i in range(2)
        ]
        outs = []
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append(out.decode())
        for p, out in zip(procs, outs):
            assert p.returncode == 0, out

        # single-process baseline on a 2-virtual-device mesh: identical
        # shard layout and reduction tree
        m1 = str(f["dir"] / "model_1proc.npz")
        p = _launch(
            [f["xml"], f["regions"], m1] + TRAIN_ARGS + ["--mesh", "2"],
            extra_env={
                "XLA_FLAGS": "--xla_force_host_platform_device_count=2"
            },
        )
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out.decode()

        a = np.load(m1)
        b = np.load(m2)
        assert set(a.files) == set(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)

"""Native C++ kernel tests: build, parity with NumPy paths, fallbacks."""

import os
import subprocess
import sys

import numpy as np
import pytest

from tehmm_tpu import native


requires_native = pytest.mark.skipif(
    not native.available(), reason="no C++ toolchain"
)


class TestNativeKernels:
    @requires_native
    def test_parse_bed_columnar(self, tmp_path):
        p = tmp_path / "x.bed"
        p.write_text(
            "# comment\n"
            "track name=foo\n"
            "chr2\t5\t10\tB\t7\n"
            "chr1\t0\t100\tA\n"
            "chr1\t100\t200\tA\n"
        )
        starts, ends, cids, vids, chroms, vals = \
            native.parse_bed_columnar(str(p), 3)
        assert starts.tolist() == [5, 0, 100]
        assert ends.tolist() == [10, 100, 200]
        assert [chroms[i] for i in cids] == ["chr2", "chr1", "chr1"]
        assert [vals[i] for i in vids] == ["B", "A", "A"]

    @requires_native
    def test_parse_value_col_score(self, tmp_path):
        p = tmp_path / "s.bed"
        p.write_text("chr1\t0\t10\tname\t42\n")
        *_ , vids, _chroms, vals = native.parse_bed_columnar(str(p), 4)
        assert vals[vids[0]] == "42"

    @requires_native
    def test_fill_intervals(self):
        col = np.zeros(20, np.uint16)
        ok = native.fill_intervals(
            col, 100,
            np.array([95, 105, 118]), np.array([102, 110, 130]),
            np.array([1, 2, 3]),
        )
        assert ok
        want = np.zeros(20, np.uint16)
        want[0:2] = 1; want[5:10] = 2; want[18:20] = 3
        np.testing.assert_array_equal(col, want)

    @requires_native
    def test_count_transitions_matches_numpy(self):
        rng = np.random.RandomState(0)
        st = rng.randint(0, 5, 1000).astype(np.int32)
        got = native.count_transitions(st, 5)
        want = np.zeros((5, 5))
        np.add.at(want, (st[:-1], st[1:]), 1)
        np.testing.assert_array_equal(got, want)

    @requires_native
    def test_count_emissions_matches_numpy(self):
        rng = np.random.RandomState(0)
        st = rng.randint(0, 4, 500).astype(np.int32)
        sym = rng.randint(0, 6, (500, 3)).astype(np.uint16)
        got = native.count_emissions(st, sym, 4, 6)
        want = np.zeros((4, 3, 6))
        for t in range(3):
            np.add.at(want, (st, t, sym[:, t].astype(int)), 1)
        np.testing.assert_array_equal(got, want)

    @requires_native
    def test_runs_encode(self):
        path = np.array([1, 1, 2, 2, 2, 0, 1], np.int32)
        s, e, v = native.runs_encode(path)
        assert s.tolist() == [0, 2, 5, 6]
        assert e.tolist() == [2, 5, 6, 7]
        assert v.tolist() == [1, 2, 0, 1]


class TestNativeDisabled:
    def test_trackdata_identical_with_and_without_native(self, tmp_path):
        """Loading through the native parser and the pure-Python path
        must produce identical symbol matrices."""
        from tehmm_tpu.io import Track, TrackList, write_bed_intervals

        rng = np.random.RandomState(3)
        rows = []
        pos = 0
        names = ["LINE", "SINE", "LTR", "DNA"]
        while pos < 5000:
            ln = rng.randint(5, 50)
            if rng.rand() < 0.7:
                rows.append(
                    ("chr1", pos, pos + ln, names[rng.randint(4)])
                )
            pos += ln
        bed = str(tmp_path / "t.bed")
        write_bed_intervals(rows, bed)

        def load():
            from tehmm_tpu.io import load_track_data

            tl = TrackList()
            tl.add(Track(name="t", path=bed))
            td = load_track_data(tl, [("chr1", 0, 5000)])
            return (
                td.tables[0].symbols.copy(),
                dict(td.category_maps["t"].to_dict()["map"]),
            )

        code = (
            "import numpy as np\n"
            "import sys; sys.path.insert(0, %r)\n"
        )
        sym_native, map_native = load()
        # subprocess with native disabled
        env = dict(os.environ, TEHMM_NO_NATIVE="1",
                   TEHMM_PLATFORM="cpu",
                   PYTHONPATH=os.path.dirname(os.path.dirname(
                       os.path.abspath(__file__))))
        script = f"""
import numpy as np
from tehmm_tpu.io import Track, TrackList, load_track_data
tl = TrackList(); tl.add(Track(name="t", path={bed!r}))
td = load_track_data(tl, [("chr1", 0, 5000)])
np.save({str(tmp_path / "sym.npy")!r}, td.tables[0].symbols)
import json
json.dump(td.category_maps["t"].to_dict()["map"],
          open({str(tmp_path / "map.json")!r}, "w"))
"""
        subprocess.run([sys.executable, "-c", script], env=env,
                       check=True, capture_output=True)
        import json

        sym_py = np.load(tmp_path / "sym.npy")
        map_py = json.load(open(tmp_path / "map.json"))
        np.testing.assert_array_equal(sym_native, sym_py)
        assert map_native == map_py


def _fb_of(x, shift, scale, log_scale):
    """The reference transform, verbatim from io/trackdata's fb_of
    (scale takes precedence when both are set) — the ONE definition
    both the parity reference and the range computation use."""
    v = x + shift
    if scale is not None:
        return np.floor(v * scale)
    return np.floor(np.log(np.maximum(v, 1e-9)) / np.log(log_scale))


class TestBinScaleNative:
    """round-5: the fused C++ scale-binning pass must reproduce the
    NumPy block loop (identical f64 math to category.bin_value)."""

    def _numpy_ref(self, vals, shift, scale, log_scale, bmin, span):
        with np.errstate(invalid="ignore"):
            fb = _fb_of(
                vals.astype(np.float64), shift, scale, log_scale
            )
            fb -= bmin
            fb[np.isnan(fb)] = span
            bins = fb.astype(np.int32)
        present = np.zeros(span, bool)
        occ = np.unique(bins)
        present[occ[occ < span]] = True
        return bins, present

    def _range(self, vals, shift, scale, log_scale):
        with np.errstate(invalid="ignore"):
            b0 = _fb_of(
                np.float64(np.nanmin(vals)), shift, scale, log_scale
            )
            b1 = _fb_of(
                np.float64(np.nanmax(vals)), shift, scale, log_scale
            )
        bmin = int(min(b0, b1))
        return bmin, int(max(b0, b1)) - bmin + 1

    @pytest.mark.parametrize(
        "shift,scale,log_scale",
        [(0.0, 2.0, None), (3.5, 0.25, None), (-1.0, -0.5, None),
         (0.0, None, 2.0), (2.0, None, 10.0), (0.0, None, 0.5),
         (0.0, 2.0, 10.0)],   # BOTH set: scale must win (precedence)
    )
    def test_matches_numpy(self, shift, scale, log_scale):
        from tehmm_tpu import native

        if not native.available():
            pytest.skip("no native lib")
        rng = np.random.RandomState(0)
        vals = rng.randn(100_000).astype(np.float64) * 10
        vals[rng.rand(len(vals)) < 0.2] = np.nan
        vals[:100] = np.arange(100) * 0.5      # exact bin edges

        bmin, span = self._range(vals, shift, scale, log_scale)
        got = native.bin_scale(
            vals, shift, scale, log_scale, bmin, span
        )
        assert got is not None
        want_bins, want_present = self._numpy_ref(
            vals, shift, scale, log_scale, bmin, span
        )
        np.testing.assert_array_equal(got[0], want_bins)
        np.testing.assert_array_equal(got[1], want_present)

    def test_out_of_range_bins_hit_sentinel_not_heap(self):
        """A caller whose bmin/span disagree with the data (or int64
        extremes) must get sentinel bins, never out-of-bounds
        present[] writes."""
        from tehmm_tpu import native

        if not native.available():
            pytest.skip("no native lib")
        vals = np.array([1e12, -1e12, 5.0, np.nan], np.float64)
        # bmin far above the data and a 64-bit bmin
        got = native.bin_scale(vals, 0.0, 1.0, None, 3 << 32, 10)
        assert got is not None
        bins, present = got
        np.testing.assert_array_equal(bins, [10, 10, 10, 10])
        assert not present.any()

    def test_nanminmax_matches_numpy(self):
        from tehmm_tpu import native

        if not native.available():
            pytest.skip("no native lib")
        rng = np.random.RandomState(3)
        vals = rng.randn(1_000_003) * 100
        vals[rng.rand(len(vals)) < 0.3] = np.nan
        got = native.nanminmax(vals)
        assert got is not None
        assert got[0] == np.nanmin(vals)
        assert got[1] == np.nanmax(vals)
        assert native.nanminmax(np.full(100, np.nan)) is None

"""The port's stage-artifact readers and writers (``io/schemas.py``,
``io/xlsx.write_xlsx_mixed``) and legacy decoders (``ops/decode_legacy.py``)
against the JAX package's.

The tolerant readers on the filtered-schema variants (names in another
order, a CLK difference column, no CLK, no recognisable names), NaN FLAG
rows (FLAG 0) and NaN CLK rows (dropped); the writers' sheet XML byte for
byte; the v1 and v2 decoders on seeded streams, every field equal.
"""

import zipfile

import numpy as np
import pytest

from slam_process_tpu.io import schemas as jax_schemas
from slam_process_tpu.io.xlsx import write_xlsx_mixed as jax_write_xlsx_mixed
from slam_process_tpu.io.xlsx import write_xlsx_table as jax_write_xlsx_table
from slam_process_tpu.ops import decode_legacy as jax_legacy
from slam_process_tpu_torch.io import schemas
from slam_process_tpu_torch.io.xlsx import write_xlsx_mixed
from slam_process_tpu_torch.ops import decode_legacy
from slam_process_tpu_torch.utils.synthetic import legacy_stream_bytes

FILTERED_VARIANTS = {
    "canonical": ["UE_Beam", "BS_Beam", "RSS值", "CLK值"],
    "clk_difference": ["UE_Beam", "BS_Beam", "RSS值", "CLK值", "CLK差值"],
    "clk_before_rss": ["UE_Beam", "BS_Beam", "CLK值", "RSS"],
    "shuffled": ["CLK差值", "RSS", "BS_Beam", "UE_Beam", "CLK"],
    "power_no_clk": ["UE", "BS", "Power"],
    "positional": ["a", "b", "c", "d"],
    "positional_three": ["x", "y", "z"],
}


def sheet_xml(path):
    with zipfile.ZipFile(path) as zf:
        return zf.read("xl/worksheets/sheet1.xml"), zf.read("xl/workbook.xml")


def table(n_cols, seed, nan_rows=()):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 1 << 20, (40, n_cols)).astype(np.float64)
    for r, c in nan_rows:
        data[r, c] = np.nan
    return data


@pytest.mark.parametrize("variant", sorted(FILTERED_VARIANTS))
def test_filtered_reader_matches_jax(tmp_path, variant):
    names = FILTERED_VARIANTS[variant]
    path = jax_write_xlsx_table(tmp_path / "f.xlsx", names,
                                table(len(names), 1, nan_rows=[(3, len(names) - 1), (9, 0)]))
    got = schemas.read_filtered_table(path)
    want = jax_schemas.read_filtered_table(path)
    assert got.dtype == want.dtype == np.int64 and got.shape[1] == 4
    np.testing.assert_array_equal(got, want)
    assert len(got) < 40   # the NaN rows dropped


@pytest.mark.parametrize("names", [jax_schemas.PARSED_COLUMNS, ["a", "b", "c", "d", "e"],
                                   ["flag", "ue_beam", "BS_BEAM", "rss", "clk"]])
def test_parsed_reader_matches_jax_with_nan_flag_and_clk(tmp_path, names):
    data = table(5, 2, nan_rows=[(0, 0), (5, 0), (7, 4), (11, 3)])
    path = jax_write_xlsx_table(tmp_path / "p.xlsx", names, data)
    got = schemas.read_parsed_table(path)
    want = jax_schemas.read_parsed_table(path)
    np.testing.assert_array_equal(got, want)
    assert len(got) == 38 and got[0, 0] == 0   # NaN FLAG -> 0; NaN CLK / RSS rows dropped


def test_writers_match_jax(tmp_path):
    frames = table(5, 3).astype(np.int64)
    assert schemas.PARSED_COLUMNS == jax_schemas.PARSED_COLUMNS
    assert schemas.FILTERED_COLUMNS == jax_schemas.FILTERED_COLUMNS
    assert sheet_xml(schemas.write_parsed_table(tmp_path / "a.xlsx", frames)) == sheet_xml(
        jax_schemas.write_parsed_table(tmp_path / "b.xlsx", frames))
    assert sheet_xml(schemas.write_filtered_table(tmp_path / "c.xlsx", frames[:, :4])) == (
        sheet_xml(jax_schemas.write_filtered_table(tmp_path / "d.xlsx", frames[:, :4])))
    for a, b in zip(schemas.split_frames(frames), jax_schemas.split_frames(frames)):
        np.testing.assert_array_equal(a, b)


def test_mixed_writer_matches_jax(tmp_path):
    cols = [["0x4A", "0x01", "a&<b>\""], [1, 2.5, float("nan")], np.array([3, -4, 1e16])]
    names = ["hex", "num", "big"]
    assert sheet_xml(write_xlsx_mixed(tmp_path / "a.xlsx", names, cols, "Parsed")) == sheet_xml(
        jax_write_xlsx_mixed(tmp_path / "b.xlsx", names, cols, "Parsed"))
    with pytest.raises(ValueError, match="ragged"):
        write_xlsx_mixed(tmp_path / "c.xlsx", ["x", "y"], [[1, 2], [1]])


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("fmt", ["v1", "v2"])
def test_legacy_decoders_match_jax(fmt, seed):
    raw = legacy_stream_bytes(fmt, n_frames=200, junk_frac=0.4, seed=seed)
    port_fn = getattr(decode_legacy, f"decode_frames_{fmt}_np")
    jax_fn = getattr(jax_legacy, f"decode_frames_{fmt}_np")
    for cut in (len(raw), len(raw) - 3, 4, 0):
        got, want = port_fn(raw[:cut]), jax_fn(raw[:cut])
        assert (got.valid, got.discarded) == (want.valid, want.discarded)
        np.testing.assert_array_equal(got.frames, want.frames)
        np.testing.assert_array_equal(got.windows, want.windows)
    assert got.frames.shape[1] == (3 if fmt == "v1" else 4)


def test_legacy_columns_and_hex_match_jax():
    assert decode_legacy.V1_COLUMNS == jax_legacy.V1_COLUMNS
    assert decode_legacy.V2_COLUMNS == jax_legacy.V2_COLUMNS
    for v in (0, 0x0F, 0xCC, 0xFF):
        assert decode_legacy.to_hex(v) == jax_legacy.to_hex(v)

"""cmrtpu_torch's figures (``cmrtpu_torch/visualization/``) against
cmrtpu's (``cmrtpu/visualization/``) on the CPU.

Every function of both modules draws the same arrays in both packages;
matplotlib's Agg PNGs are byte-stable, so the two PNGs are compared byte
for byte (a figure returned without a path is saved at 96 dpi first).
``create_eval_plot`` and ``plot_radar_chart`` take a dict of columns or a
list of row dicts in the port and pandas frames in cmrtpu: the violins'
data (None/NaN cells skipped as ``dropna`` skips them) and the radar's
labels and values are equal, and so are the PNGs. The numbers the
functions return (dice scores, Bland-Altman mean and SD, the confusion
matrix) are equal exactly.
"""

import io

import numpy as np
import pandas as pd
import pytest

from cmrtpu.visualization import analysis as JA
from cmrtpu.visualization import visualize as JV
from cmrtpu_torch.visualization import analysis as VA
from cmrtpu_torch.visualization import visualize as V


@pytest.fixture(scope="module")
def vol():
    rng = np.random.default_rng(0)
    img = rng.normal(size=(6, 32, 32)).astype(np.float32)
    msk = np.zeros((6, 32, 32), np.uint8)
    msk[:, 10:14, 10:14] = 1
    msk[:, 20:24, 20:24] = 2
    return img, msk


def _png(fig):
    buf = io.BytesIO()
    fig.savefig(buf, format="png", dpi=96)
    V.pyplot().close(fig)
    return buf.getvalue()


def _file(path):
    with open(path, "rb") as fh:
        return fh.read()


def _same_file(tmp_path, draw):
    """``draw(module_pair, path)`` for cmrtpu and the port; the PNGs."""
    a, b = str(tmp_path / "ref.png"), str(tmp_path / "got.png")
    draw((JV, JA), a)
    draw((V, VA), b)
    ref, got = _file(a), _file(b)
    assert ref[:8] == b"\x89PNG\r\n\x1a\n" and got == ref


FILE_CASES = {
    "plot_2d_or_3d-2d": lambda m, v, p: m[0].plot_2d_or_3d(
        v[0][0], v[1][0], path=p),
    "plot_2d_or_3d-3d": lambda m, v, p: m[0].plot_2d_or_3d(
        v[0][:3], v[1][:3], path=p),
    "show_2D_or_3D": lambda m, v, p: m[0].show_2D_or_3D(
        v[0][:2], v[1][:2], path=p),
    "plot_3d_vol": lambda m, v, p: m[0].plot_3d_vol(
        v[0], v[1], cols=3, path=p),
    "plot_4d_vol": lambda m, v, p: m[0].plot_4d_vol(
        np.stack([v[0], v[0] * 2]), path=p),
    "save_prediction_overlays": lambda m, v, p: m[0].save_prediction_overlays(
        v[0][..., None], np.stack([v[1] == 1, v[1] == 2], -1).astype(
            np.float32), np.stack([v[1] == 2, v[1] == 1], -1).astype(
            np.float32), p, max_samples=3),
    "write_figure": lambda m, v, p: m[0].write_figure(
        m[0].plot_2d_or_3d(v[0][1]), p),
    "plot_dice_per_slice_bar": lambda m, v, p: m[1].plot_dice_per_slice_bar(
        v[1], np.where(np.arange(6)[:, None, None] == 3, 0, v[1]),
        save_path=p),
    "plot_confusion_matrix": lambda m, v, p: m[1].plot_confusion_matrix(
        [0, 0, 1, 1, 2], [0, 1, 1, 1, 2], ["bg", "ant", "inf"],
        normalize=True, title="cm", path=p),
    "plot_value_histogram": lambda m, v, p: m[1].plot_value_histogram(
        v[0], f_name=p),
    "show_phases": lambda m, v, p: m[1].show_phases(
        np.eye(2, 30, 3), pred=np.eye(2, 30, 4), phase_names=("ED", "ES"),
        path=p),
}


@pytest.mark.parametrize("case", sorted(FILE_CASES))
def test_written_png_equals_cmrtpus(vol, tmp_path, case):
    _same_file(tmp_path, lambda m, p: FILE_CASES[case](m, vol, p))


FIGURE_CASES = {
    "show_slice_transparent": lambda m, v: m[0].show_slice_transparent(
        v[0][0], v[1][0], show=False, dpi=50),
    "show_slice_transparent-onehot": lambda m, v: m[0].show_slice_transparent(
        v[0][0], np.stack([v[1][0] == k for k in range(4)], -1).astype(
            np.float32), show=False, dpi=50),
    "show_slice_transparent-mask-only": lambda m, v: (
        m[0].show_slice_transparent(None, v[1][0], show=False, dpi=50)),
    "show_slice": lambda m, v: m[0].show_slice(
        v[0][:3], v[1][:3], show=False),
    "bland_altman_metric_plot": lambda m, v: m[1].bland_altman_metric_plot(
        [1.0, 2.0, 3.0, 4.5], [1.5, 2.0, 3.5, 4.0], label="mm")[0],
    "create_quiver_plot": lambda m, v: m[1].create_quiver_plot(
        np.stack([v[0][0], v[0][1]], -1), n=4),
    "show_phases_transpose": lambda m, v: m[1].show_phases_transpose(
        np.eye(2, 30, 3).T, pred=np.eye(2, 30, 5).T,
        phase_names=("ED", "ES")),
}


@pytest.mark.parametrize("case", sorted(FIGURE_CASES))
def test_returned_figure_equals_cmrtpus(vol, case):
    ref = _png(FIGURE_CASES[case]((JV, JA), vol))
    assert _png(FIGURE_CASES[case]((V, VA), vol)) == ref


def test_returned_numbers_equal_cmrtpus(vol):
    _, msk = vol
    pred = msk.copy()
    pred[3] = 0
    (_, ref), (_, got) = (m.plot_dice_per_slice_bar(msk, pred)
                          for m in (JA, VA))
    assert got == ref and got[3] < 1.0 == got[0]
    (_, ref), (_, got) = (m.bland_altman_metric_plot([1.0, 2.0, 3.0],
                                                     [1.5, 2.5, 2.0])
                          for m in (JA, VA))
    assert got == ref
    (_, ref), (_, got) = (m.plot_confusion_matrix([0, 1, 1, 2], [0, 1, 2, 2],
                                                  ["a", "b", "c"])
                          for m in (JA, VA))
    np.testing.assert_array_equal(got, ref)
    V.pyplot().close("all")


def test_small_helpers_equal_cmrtpus(vol):
    img, msk = vol
    for pct in (0.5, 1.0, 5.0, 42.4):
        assert V.my_autopct(pct) == JV.my_autopct(pct)
    for arr, is_mask in ((img[0][..., None], False), (img[:5], False),
                         (np.zeros((8, 8, 4)), True), (msk[:2], True)):
        np.testing.assert_array_equal(V._as_2d_slice(arr, is_mask),
                                      JV._as_2d_slice(arr, is_mask))
    assert V.show_slice_transparent(None, None) is None


EVAL_COLUMNS = {"LV": [0.9, 0.85, None, 0.7], "RV": [0.8, 0.7, 0.75, 0.6]}


def test_create_eval_plot_from_columns_and_rows(tmp_path):
    """The port's dict of columns and its list of rows against cmrtpu fed
    the same table as pandas frames (None -> NaN, dropped)."""
    frame = pd.DataFrame(EVAL_COLUMNS)
    rows = [dict(zip(EVAL_COLUMNS, r)) for r in zip(*EVAL_COLUMNS.values())]
    for cols in (EVAL_COLUMNS, rows):
        got = VA.violin_data(VA.as_columns(cols))
        ref = [frame[c].dropna().values for c in frame.columns]
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
    scaled = {k: [None if v is None else v * 10 for v in vs]
              for k, vs in EVAL_COLUMNS.items()}
    for port_table in (EVAL_COLUMNS, rows):
        a, b = str(tmp_path / "ref.png"), str(tmp_path / "got.png")
        JA.create_eval_plot(frame, frame * 10, eval_name="t", path=a)
        VA.create_eval_plot(port_table, scaled, eval_name="t", path=b)
        assert _file(a) == _file(b)


def test_create_eval_plot_rows_with_absent_cells():
    rows = [{"a": 1.0, "b": 2.0}, {"a": float("nan")}, {"b": 4.0, "c": 5}]
    cols = VA.as_columns(rows)
    frame = pd.DataFrame(rows)
    assert list(cols) == list(frame.columns)
    for g, c in zip(VA.violin_data(cols), frame.columns):
        np.testing.assert_array_equal(g, frame[c].dropna().values)


def test_radar_chart_from_rows_and_columns():
    columns = {"patient": ["p1", "p2"], "d_ant": [3.2, 1.5],
               "d_inf": [2.1, 2.0], "n": [4, 6], "ok": [True, False],
               "tpr": [0.9, 0.8]}
    frame = pd.DataFrame(columns)
    rows = frame.to_dict("records")
    for index in (0, 1):
        want = frame.select_dtypes(include=[np.number]).iloc[index]
        for table in (columns, rows):
            labels, values = VA.radar_values(table, index)
            assert labels == list(want.index)
            assert values == [float(v) for v in want.values]
        ref = _png(JA.plot_radar_chart(frame, index))
        assert _png(VA.plot_radar_chart(rows, index)) == ref
        assert _png(VA.plot_radar_chart(columns, index)) == ref

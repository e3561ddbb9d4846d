"""Minimal xlsx reader / writer for numeric tables (zipfile + regex).

A copy of ``slam_process_tpu/io/xlsx.py``'s ``read_xlsx_table``,
``write_xlsx_table`` and ``write_xlsx_mixed``: sheets are read as XML with
regular expressions over ``<row>`` blocks and written by string assembly
into a zip, so no spreadsheet package is needed.
"""

from __future__ import annotations

import html
import re
import zipfile
from pathlib import Path
from typing import List, Sequence, Tuple, Union

import numpy as np

# Cells may omit the r="A1" reference (the writer below does); the column
# index then falls back to "next column after the previous cell".
_CELL_RE = re.compile(
    rb'<c(?: r="([A-Z]+)\d+")?(?:[^>/]*?t="([a-zA-Z]+)")?[^>/]*(?:/>|>'
    rb"(?:.*?<(?:v|t)[^>]*>([^<]*)</(?:v|t)>)?)",
    re.S,
)
_ROW_RE = re.compile(rb"<row[ >].*?</row>", re.S)
_SHARED_RE = re.compile(rb"<si>(?:<t[^>]*>([^<]*)</t>|.*?)</si>", re.S)


def _col_index(letters: bytes) -> int:
    idx = 0
    for ch in letters:
        idx = idx * 26 + (ch - ord("A") + 1)
    return idx - 1


def _read_shared_strings(zf: zipfile.ZipFile) -> List[str]:
    try:
        xml = zf.read("xl/sharedStrings.xml")
    except KeyError:
        return []
    out = []
    for m in _SHARED_RE.finditer(xml):
        s = m.group(1)
        out.append(html.unescape(s.decode("utf-8")) if s is not None else "")
    return out


def _sheet_names(zf: zipfile.ZipFile) -> List[str]:
    names = [n for n in zf.namelist() if re.fullmatch(r"xl/worksheets/sheet\d+\.xml", n)]
    return sorted(names, key=lambda n: int(re.search(r"(\d+)", n).group(1)))


def read_xlsx_table(path: Union[str, Path], sheet: int = 0,
                    header: bool = True) -> Tuple[List[str], np.ndarray]:
    """Read one sheet of a numeric xlsx table.

    Returns (column_names, values [rows, cols] float64); non-numeric body
    cells become NaN.  With ``header=False`` column names are X0..Xn.
    """
    path = Path(path)
    with zipfile.ZipFile(path) as zf:
        shared = _read_shared_strings(zf)
        sheets = _sheet_names(zf)
        if sheet >= len(sheets):
            raise IndexError(f"sheet {sheet} not in {path} ({len(sheets)} sheets)")
        xml = zf.read(sheets[sheet])

    rows: List[List[object]] = []
    ncols = 0
    for rm in _ROW_RE.finditer(xml):
        row: List[object] = []
        for cm in _CELL_RE.finditer(rm.group(0)):
            ci = _col_index(cm.group(1)) if cm.group(1) else len(row)
            ctype = cm.group(2) or b""
            raw = cm.group(3)
            if raw is None:
                val: object = None
            elif ctype == b"s":
                val = shared[int(raw)]
            elif ctype in (b"str", b"inlineStr"):
                val = html.unescape(raw.decode("utf-8"))
            else:
                try:
                    val = float(raw)
                except ValueError:
                    val = html.unescape(raw.decode("utf-8", "ignore"))
            while len(row) < ci:
                row.append(None)
            row.append(val)
        rows.append(row)
        ncols = max(ncols, len(row))

    if not rows:
        return [], np.zeros((0, 0))

    if header:
        names = [str(v) if v is not None else f"X{i}"
                 for i, v in enumerate(rows[0] + [None] * (ncols - len(rows[0])))]
        body = rows[1:]
    else:
        names = [f"X{i}" for i in range(ncols)]
        body = rows

    data = np.full((len(body), ncols), np.nan)
    for r, row in enumerate(body):
        for c, v in enumerate(row):
            if isinstance(v, float):
                data[r, c] = v
            elif isinstance(v, str):
                try:
                    data[r, c] = float(v)
                except ValueError:
                    pass
    return names, data


_XLSX_STATIC = {
    "[Content_Types].xml": (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">'
        '<Default Extension="rels" ContentType="application/vnd.openxmlformats-package.relationships+xml"/>'
        '<Default Extension="xml" ContentType="application/xml"/>'
        '<Override PartName="/xl/workbook.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>'
        '<Override PartName="/xl/worksheets/sheet1.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.worksheet+xml"/>'
        "</Types>"
    ),
    "_rels/.rels": (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">'
        '<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/officeDocument" Target="xl/workbook.xml"/>'
        "</Relationships>"
    ),
    "xl/_rels/workbook.xml.rels": (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">'
        '<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/worksheet" Target="worksheets/sheet1.xml"/>'
        "</Relationships>"
    ),
}


def _esc(s: str) -> str:
    return (s.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;")
            .replace('"', "&quot;"))


def write_xlsx_table(path: Union[str, Path], columns: Sequence[str], data: np.ndarray,
                     sheet_name: str = "Sheet1") -> Path:
    """Write a numeric table with a string header row as a minimal xlsx."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    data = np.asarray(data, dtype=np.float64)
    if data.ndim != 2:
        raise ValueError("data must be 2-D")

    parts: List[str] = [
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<worksheet xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main">'
        "<sheetData>"
    ]
    hdr = "".join(f'<c t="inlineStr"><is><t>{_esc(str(c))}</t></is></c>' for c in columns)
    parts.append(f"<row>{hdr}</row>")
    cols_txt = []
    for c in range(data.shape[1]):
        col = data[:, c]
        if np.all(np.isnan(col)):
            cols_txt.append([""] * data.shape[0])
            continue
        ints = np.all(np.isnan(col) | (np.floor(col) == col))
        if ints and np.nanmax(np.abs(col), initial=0) < 1e15:
            txt = [("" if np.isnan(v) else str(int(v))) for v in col]
        else:
            txt = [("" if np.isnan(v) else repr(float(v))) for v in col]
        cols_txt.append(txt)
    for r in range(data.shape[0]):
        cells = "".join(f"<c><v>{cols_txt[c][r]}</v></c>" if cols_txt[c][r] else "<c/>"
                        for c in range(data.shape[1]))
        parts.append(f"<row>{cells}</row>")
    parts.append("</sheetData></worksheet>")
    return _save_xlsx(path, "".join(parts), sheet_name)


def write_xlsx_mixed(path: Union[str, Path], columns: Sequence[str], cols_data: Sequence[Sequence],
                     sheet_name: str = "Sheet1") -> Path:
    """Write a table with per-column types: a column whose first value is a
    str becomes inlineStr cells, any other numeric value cells (the v1 / v2
    legacy exports mix raw hex-string columns with decimal ones).
    ``cols_data`` is one sequence per column, all the same length."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if len(cols_data) != len(columns):
        raise ValueError("one data column per header required")
    n_rows = len(cols_data[0]) if cols_data else 0
    cols_txt: List[List[str]] = []
    for col in cols_data:
        if len(col) != n_rows:
            raise ValueError("ragged columns")
        vals = list(col)
        if vals and isinstance(vals[0], str):
            cols_txt.append([f'<c t="inlineStr"><is><t>{_esc(v)}</t></is></c>' for v in vals])
            continue
        txt = []
        for v in vals:
            f = float(v)
            if f != f:   # NaN
                txt.append("<c/>")
            elif f.is_integer() and abs(f) < 1e15:
                txt.append(f"<c><v>{int(f)}</v></c>")
            else:
                txt.append(f"<c><v>{f!r}</v></c>")
        cols_txt.append(txt)
    parts: List[str] = [
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<worksheet xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main">'
        "<sheetData>"
    ]
    hdr = "".join(f'<c t="inlineStr"><is><t>{_esc(str(c))}</t></is></c>' for c in columns)
    parts.append(f"<row>{hdr}</row>")
    for r in range(n_rows):
        parts.append("<row>" + "".join(c[r] for c in cols_txt) + "</row>")
    parts.append("</sheetData></worksheet>")
    return _save_xlsx(path, "".join(parts), sheet_name)


def _save_xlsx(path: Path, sheet_xml: str, sheet_name: str) -> Path:
    """Zip one worksheet with its workbook and the static parts; a locked
    target (e.g. open in a spreadsheet program) is retried once as
    <stem>_out.xlsx.  Returns the path written."""
    workbook_xml = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<workbook xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main" '
        'xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships">'
        f'<sheets><sheet name="{_esc(sheet_name)}" sheetId="1" r:id="rId1"/></sheets>'
        "</workbook>"
    )

    def _save(target: Path) -> None:
        with zipfile.ZipFile(target, "w", zipfile.ZIP_DEFLATED) as zf:
            for name, content in _XLSX_STATIC.items():
                zf.writestr(name, content)
            zf.writestr("xl/workbook.xml", workbook_xml)
            zf.writestr("xl/worksheets/sheet1.xml", sheet_xml)

    try:
        _save(path)
    except PermissionError:
        path = path.with_name(path.stem + "_out.xlsx")
        _save(path)
    return path

"""Minimal XLSX (SpreadsheetML) writer on the stdlib zipfile (a copy of
reina_tpu/runtime/xlsx.py).

The reference's Dash result table offers an Excel download
(reference components/results.py:294-331, dash_table
export_format="xlsx"); this produces the equivalent workbook without
an openpyxl dependency: one sheet, inline strings (no sharedStrings
part), numbers as native numeric cells.
"""
from __future__ import annotations

import io
import zipfile
from typing import Iterable, List, Sequence
from xml.sax.saxutils import escape

_CONTENT_TYPES = (
    '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
    '<Types xmlns="http://schemas.openxmlformats.org/package/2006/'
    'content-types">'
    '<Default Extension="rels" ContentType="application/vnd.'
    'openxmlformats-package.relationships+xml"/>'
    '<Default Extension="xml" ContentType="application/xml"/>'
    '<Override PartName="/xl/workbook.xml" ContentType="application/vnd.'
    'openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>'
    '<Override PartName="/xl/worksheets/sheet1.xml" ContentType='
    '"application/vnd.openxmlformats-officedocument.spreadsheetml.'
    'worksheet+xml"/>'
    '</Types>')

_ROOT_RELS = (
    '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
    '<Relationships xmlns="http://schemas.openxmlformats.org/package/'
    '2006/relationships">'
    '<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/'
    'officeDocument/2006/relationships/officeDocument" '
    'Target="xl/workbook.xml"/>'
    '</Relationships>')

_WORKBOOK = (
    '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
    '<workbook xmlns="http://schemas.openxmlformats.org/spreadsheetml/'
    '2006/main" xmlns:r="http://schemas.openxmlformats.org/'
    'officeDocument/2006/relationships">'
    '<sheets><sheet name="{name}" sheetId="1" r:id="rId1"/></sheets>'
    '</workbook>')

_WORKBOOK_RELS = (
    '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
    '<Relationships xmlns="http://schemas.openxmlformats.org/package/'
    '2006/relationships">'
    '<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/'
    'officeDocument/2006/relationships/worksheet" '
    'Target="worksheets/sheet1.xml"/>'
    '</Relationships>')


def _cell(value) -> str:
    if value is None:
        return "<c/>"
    if isinstance(value, bool):
        value = int(value)
    if isinstance(value, (int, float)):
        if value != value or value in (float("inf"), float("-inf")):
            return "<c/>"  # NaN/inf have no numeric-cell representation
        if isinstance(value, float) and value.is_integer():
            value = int(value)
        return f"<c><v>{value}</v></c>"
    return f'<c t="inlineStr"><is><t>{escape(str(value))}</t></is></c>'


def workbook_bytes(header: Sequence, rows: Iterable[Sequence],
                   sheet_name: str = "Results") -> bytes:
    """One-sheet workbook: ``header`` as the first row, then ``rows``.
    Numbers (incl. numpy scalars via float()) become numeric cells,
    everything else inline strings."""
    parts: List[str] = ['<?xml version="1.0" encoding="UTF-8" '
                        'standalone="yes"?>'
                        '<worksheet xmlns="http://schemas.openxmlformats'
                        '.org/spreadsheetml/2006/main"><sheetData>']
    for row in [header, *rows]:
        cells = []
        for v in row:
            if hasattr(v, "item"):   # numpy scalar
                v = v.item()
            cells.append(_cell(v))
        parts.append("<row>" + "".join(cells) + "</row>")
    parts.append("</sheetData></worksheet>")
    sheet_xml = "".join(parts)

    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("[Content_Types].xml", _CONTENT_TYPES)
        z.writestr("_rels/.rels", _ROOT_RELS)
        z.writestr("xl/workbook.xml",
                   _WORKBOOK.format(name=escape(sheet_name[:31])))
        z.writestr("xl/_rels/workbook.xml.rels", _WORKBOOK_RELS)
        z.writestr("xl/worksheets/sheet1.xml", sheet_xml)
    return buf.getvalue()

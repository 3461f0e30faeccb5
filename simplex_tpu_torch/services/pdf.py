# Copied from simplex_tpu/services/pdf.py; keep in step (tests/test_torch_core.py).
"""PDF report generation — a from-scratch minimal PDF writer (no reportlab).

Covers the reference's ``PdfReportService``
(``app/services/pdf_report_service.py:43-178``): an A4
report with (1) the problem definition, (2) the solution (status / Z /
variable table), and (3) every intermediate tableau with the pivot cell
highlighted in red.  reportlab is not available in this environment, so the
writer emits the PDF object graph directly: Helvetica text, vector lines
and filled rectangles, multi-page with automatic page breaks.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

A4 = (595.28, 841.89)
MARGIN = 50.0
LINE = 14.0

_RED = (0.82, 0.0, 0.0)
_RED_BG = (1.0, 0.94, 0.94)
_GREY_BG = (0.92, 0.92, 0.95)
_BLACK = (0.0, 0.0, 0.0)


def _esc(text: str) -> str:
    out = []
    for ch in str(text):
        if ch in "\\()":
            out.append("\\" + ch)
        elif ord(ch) < 32 or ord(ch) > 255:
            out.append("?")
        else:
            out.append(ch)
    return "".join(out)


class _Page:
    def __init__(self):
        self.ops: List[str] = []

    def text(self, x: float, y: float, s: str, size: float = 10.0,
             bold: bool = False, color=_BLACK):
        font = "/F2" if bold else "/F1"
        r, g, b = color
        self.ops.append(
            f"BT {r:.3f} {g:.3f} {b:.3f} rg {font} {size:.1f} Tf "
            f"{x:.2f} {y:.2f} Td ({_esc(s)}) Tj ET"
        )

    def rect(self, x: float, y: float, w: float, h: float, fill=None,
             stroke: Optional[Tuple[float, float, float]] = None,
             line_width: float = 0.5):
        if fill is not None:
            r, g, b = fill
            self.ops.append(f"{r:.3f} {g:.3f} {b:.3f} rg "
                            f"{x:.2f} {y:.2f} {w:.2f} {h:.2f} re f")
        if stroke is not None:
            r, g, b = stroke
            self.ops.append(f"{line_width:.2f} w {r:.3f} {g:.3f} {b:.3f} RG "
                            f"{x:.2f} {y:.2f} {w:.2f} {h:.2f} re S")

    def line(self, x1, y1, x2, y2, color=_BLACK, width=0.5):
        r, g, b = color
        self.ops.append(f"{width:.2f} w {r:.3f} {g:.3f} {b:.3f} RG "
                        f"{x1:.2f} {y1:.2f} m {x2:.2f} {y2:.2f} l S")

    def stream(self) -> bytes:
        return "\n".join(self.ops).encode("latin-1", errors="replace")


class PdfDocument:
    """Multi-page A4 document with a cursor-based layout helper."""

    def __init__(self):
        self.pages: List[_Page] = []
        self.new_page()

    def new_page(self):
        self.page = _Page()
        self.pages.append(self.page)
        self.y = A4[1] - MARGIN

    def ensure_space(self, height: float):
        if self.y - height < MARGIN:
            self.new_page()

    def heading(self, s: str, size: float = 14.0, color=_BLACK):
        self.ensure_space(size + 10)
        self.y -= size + 4
        self.page.text(MARGIN, self.y, s, size=size, bold=True, color=color)
        self.y -= 6

    def paragraph(self, s: str, size: float = 10.0, bold=False,
                  color=_BLACK, indent: float = 0.0):
        self.ensure_space(LINE)
        self.y -= LINE
        self.page.text(MARGIN + indent, self.y, s, size=size, bold=bold,
                       color=color)

    def spacer(self, h: float = 8.0):
        self.y -= h

    def table(self, rows: Sequence[Sequence], col_width: float = None,
              highlight: Optional[Tuple[int, int]] = None,
              font_size: float = 8.0, row_h: float = 14.0,
              header_rows: int = 1):
        """Grid table with optional (row, col) cell highlight (0-indexed
        into ``rows``)."""
        if not rows:
            return
        ncols = max(len(r) for r in rows)
        avail = A4[0] - 2 * MARGIN
        cw = col_width or min(avail / ncols, 70.0)
        total_w = cw * ncols

        for i, row in enumerate(rows):
            self.ensure_space(row_h + 2)
            top = self.y
            bottom = top - row_h
            for j in range(ncols):
                x = MARGIN + j * cw
                cell = row[j] if j < len(row) else ""
                is_hl = highlight is not None and (i, j) == tuple(highlight)
                fill = (_RED_BG if is_hl
                        else _GREY_BG if i < header_rows else None)
                self.page.rect(x, bottom, cw, row_h, fill=fill,
                               stroke=(0.6, 0.6, 0.6))
                text = (f"{cell:.4f}" if isinstance(cell, float) else
                        str(cell))
                if len(text) > int(cw / (font_size * 0.5)):
                    text = text[: int(cw / (font_size * 0.5))]
                color = _RED if is_hl else _BLACK
                self.page.text(x + 2.5, bottom + 3.5, text, size=font_size,
                               bold=(i < header_rows or is_hl), color=color)
            self.y = bottom
        self.spacer(6)

    # ------------------------------------------------------------------ #
    def render(self) -> bytes:
        objs: List[bytes] = []

        def add(obj: bytes) -> int:
            objs.append(obj)
            return len(objs)  # 1-based object number

        font1 = add(b"<< /Type /Font /Subtype /Type1 "
                    b"/BaseFont /Helvetica >>")
        font2 = add(b"<< /Type /Font /Subtype /Type1 "
                    b"/BaseFont /Helvetica-Bold >>")

        content_ids = []
        for p in self.pages:
            data = p.stream()
            content_ids.append(add(
                b"<< /Length %d >>\nstream\n%s\nendstream"
                % (len(data), data)))

        pages_id = len(objs) + len(self.pages) + 1
        page_ids = []
        for cid in content_ids:
            page_ids.append(add(
                (f"<< /Type /Page /Parent {pages_id} 0 R "
                 f"/MediaBox [0 0 {A4[0]:.2f} {A4[1]:.2f}] "
                 f"/Resources << /Font << /F1 {font1} 0 R /F2 {font2} 0 R "
                 f">> >> /Contents {cid} 0 R >>").encode()))

        kids = " ".join(f"{pid} 0 R" for pid in page_ids)
        real_pages_id = add(
            (f"<< /Type /Pages /Kids [{kids}] "
             f"/Count {len(page_ids)} >>").encode())
        assert real_pages_id == pages_id, (real_pages_id, pages_id)
        catalog = add(f"<< /Type /Catalog /Pages {pages_id} 0 R >>".encode())

        out = bytearray(b"%PDF-1.4\n")
        offsets = [0]
        for i, obj in enumerate(objs, start=1):
            offsets.append(len(out))
            out += f"{i} 0 obj\n".encode() + obj + b"\nendobj\n"
        xref_at = len(out)
        out += f"xref\n0 {len(objs) + 1}\n".encode()
        out += b"0000000000 65535 f \n"
        for off in offsets[1:]:
            out += f"{off:010d} 00000 n \n".encode()
        out += (f"trailer\n<< /Size {len(objs) + 1} /Root {catalog} 0 R >>\n"
                f"startxref\n{xref_at}\n%%EOF\n").encode()
        return bytes(out)


class PdfReportService:
    """Solution report → PDF file (same sections as the reference)."""

    def __init__(self, report: Dict, filepath: str):
        self.report = report or {}
        self.filepath = filepath

    def generate(self) -> str:
        doc = PdfDocument()
        doc.heading("Reporte de Solución — Programación Lineal", size=16)
        doc.spacer(4)

        self._problem_section(doc)
        self._solution_section(doc)
        self._sensitivity_section(doc)
        self._tableaus_section(doc)

        with open(self.filepath, "wb") as f:
            f.write(doc.render())
        return self.filepath

    # ------------------------------------------------------------------ #
    def _problem_section(self, doc: PdfDocument):
        doc.heading("1. Definición del Problema", size=13)
        problem = self.report.get("problema_definicion", {})
        fo = problem.get("funcion_objetivo", {})
        coef = fo.get("coefficients", {})
        kind = "Maximizar" if fo.get("type") == "maximize" else "Minimizar"
        terms = " + ".join(f"{v}·{k}" for k, v in coef.items())
        doc.paragraph(f"{kind}:  Z = {terms}")
        doc.spacer(2)
        doc.paragraph("Sujeto a:", bold=True)
        for con in problem.get("restricciones", []):
            lhs = " + ".join(f"{v}·{k}"
                             for k, v in con.get("coefficients", {}).items())
            doc.paragraph(f"{lhs}  {con.get('operator')}  {con.get('rhs')}",
                          indent=14)
        doc.paragraph("x_i >= 0 para todas las variables", indent=14)
        doc.spacer(8)

    def _solution_section(self, doc: PdfDocument):
        doc.heading("2. Solución Encontrada", size=13)
        sol = self.report.get("solucion_encontrada", {})
        status = sol.get("status", "?")
        ok = status == "Solucion Factible"
        doc.paragraph(f"Estado: {status}", bold=True,
                      color=(0.0, 0.5, 0.0) if ok else _RED)
        msg = sol.get("mensaje_solver")
        if msg:
            doc.paragraph(f"Mensaje del solver: {msg}")
        if ok:
            z = sol.get("valor_optimo_z")
            if z is not None:
                doc.paragraph(f"Valor óptimo Z = {z:.4f}", bold=True)
            values = sol.get("valores_variables") or {}
            if values:
                rows = [["Variable", "Valor"]]
                for k, v in values.items():
                    rows.append([k, float(v)])
                doc.table(rows, col_width=100.0)
        doc.spacer(8)

    def _sensitivity_section(self, doc: PdfDocument):
        sens = self.report.get("analisis_sensibilidad")
        if not sens:
            return
        doc.heading("3. Análisis de Sensibilidad", size=13)
        doc.paragraph("Precios sombra (dZ/db por restricción):", bold=True)
        rows = [["Restricción", "Precio sombra"]]
        for k, v in (sens.get("precios_sombra") or {}).items():
            rows.append([k, float(v)])
        doc.table(rows, col_width=120.0)
        doc.spacer(4)
        doc.paragraph("Costos reducidos por variable:", bold=True)
        rows = [["Variable", "Costo reducido"]]
        for k, v in (sens.get("costos_reducidos") or {}).items():
            rows.append([k, float(v)])
        doc.table(rows, col_width=120.0)
        doc.spacer(8)

    def _tableaus_section(self, doc: PdfDocument):
        tables = self.report.get("tablas_intermedias") or []
        if not tables:
            return
        doc.heading("4. Tablas Intermedias (Método Simplex)", size=13)
        note = self.report.get("nota_historial")
        if note:
            doc.paragraph(note, bold=True)
        for entry in tables:
            doc.paragraph(entry.get("title", ""), bold=True)
            rows = entry.get("table") or []
            pivot = entry.get("pivot")
            highlight = None
            if pivot is not None:
                # +1 for the header row and label column.
                highlight = (pivot[0] + 1, pivot[1] + 1)
            doc.table(rows, highlight=highlight)

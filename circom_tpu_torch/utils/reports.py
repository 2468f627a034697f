"""Diagnostics: reports with source spans and stable codes.

Python counterpart of the reference's Report system
(program_structure/src/program_library/error_definition.rs:34-151,
error_code.rs:5-262): errors/warnings carry primary/secondary labeled
spans and render with a source excerpt, caret underline and the stable
code (e.g. P1004, T2021) so downstream tooling can match on codes.
"""

from dataclasses import dataclass, field


@dataclass(slots=True)
class Label:
    file_id: int
    start: int
    end: int
    message: str


class Report(Exception):
    def __init__(self, severity: str, code: str, message: str):
        super().__init__(message)
        self.severity = severity  # 'error' | 'warning'
        self.code = code
        self.message = message
        self.primary: list[Label] = []
        self.secondary: list[Label] = []
        self.notes: list[str] = []

    @staticmethod
    def error(message: str, code: str) -> "Report":
        return Report("error", code, message)

    @staticmethod
    def warning(message: str, code: str) -> "Report":
        return Report("warning", code, message)

    def add_primary(self, file_id: int, start: int, end: int, message: str = "here"):
        self.primary.append(Label(file_id, start, end, message))
        return self

    def add_secondary(self, file_id: int, start: int, end: int, message: str = ""):
        self.secondary.append(Label(file_id, start, end, message))
        return self

    def add_note(self, note: str):
        self.notes.append(note)
        return self

    def render(self, file_library=None) -> str:
        head = f"{self.severity}[{self.code}]: {self.message}"
        lines = [head]
        for lab in self.primary + self.secondary:
            if file_library is None:
                continue
            src, path = file_library.get_source(lab.file_id), file_library.get_path(lab.file_id)
            line_no = src.count("\n", 0, lab.start) + 1
            line_start = src.rfind("\n", 0, lab.start) + 1
            line_end = src.find("\n", lab.start)
            if line_end < 0:
                line_end = len(src)
            col = lab.start - line_start + 1
            excerpt = src[line_start:line_end]
            caret_len = max(1, min(lab.end, line_end) - lab.start)
            lines.append(f"  --> {path}:{line_no}:{col}")
            lines.append(f"   | {excerpt}")
            lines.append(f"   | {' ' * (col - 1)}{'^' * caret_len} {lab.message}")
        for n in self.notes:
            lines.append(f"   = note: {n}")
        return "\n".join(lines)


class ReportCollection(Exception):
    """A batch of reports (the parser recovers and reports many at once)."""

    def __init__(self, reports=None):
        super().__init__("report collection")
        self.reports = list(reports or [])

    def add(self, report: Report):
        self.reports.append(report)

    def extend(self, other):
        self.reports.extend(other.reports if isinstance(other, ReportCollection) else other)

    @property
    def has_errors(self) -> bool:
        return any(r.severity == "error" for r in self.reports)

    def render(self, file_library=None) -> str:
        return "\n\n".join(r.render(file_library) for r in self.reports)


class FileLibrary:
    """Source store keyed by file id (file_definition.rs:11-46)."""

    def __init__(self):
        self._paths: list[str] = []
        self._sources: list[str] = []

    def add(self, path: str, source: str) -> int:
        self._paths.append(path)
        self._sources.append(source)
        return len(self._paths) - 1

    def get_source(self, file_id: int) -> str:
        return self._sources[file_id]

    def get_path(self, file_id: int) -> str:
        return self._paths[file_id]

    def __len__(self):
        return len(self._paths)

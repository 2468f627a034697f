"""ProgramArchive: parsed program library + multi-file include resolution.

Mirrors the reference's parser driver (parser/src/lib.rs:60-164:
include BFS over a FileStack, per-file pragma/version checks, single-main
enforcement) and ProgramArchive
(program_structure/src/program_library/program_archive.rs:14-78) with
merged template/function/bus tables and duplicate detection
(program_merger.rs:1-138).
"""

import os
from dataclasses import dataclass, field as dfield

from .ast import BusDef, FileAst, Function, MainComponent, Template
from .parser import parse_source
from ..utils.reports import FileLibrary, Report, ReportCollection

COMPILER_VERSION = (2, 2, 3)  # language level we implement (reference 2.2.3)


@dataclass
class ProgramArchive:
    file_library: FileLibrary
    functions: dict          # name -> Function
    templates: dict          # name -> Template
    buses: dict              # name -> BusDef
    main: MainComponent
    main_file_id: int
    custom_gates: bool
    prime: str
    field_p: int

    def get_template(self, name):
        return self.templates[name]

    def get_function(self, name):
        return self.functions[name]


def _version_ok(file_ver, compiler=COMPILER_VERSION) -> bool:
    return file_ver is None or file_ver <= compiler


def run_parser(path: str, field_p: int, prime: str, link_libraries=(),
               no_init: bool = False) -> tuple:
    """Parse `path` and all transitive includes -> (ProgramArchive, warnings).

    Raises ReportCollection on errors.
    """
    file_library = FileLibrary()
    warnings = ReportCollection()
    errors = ReportCollection()
    parsed: dict[str, FileAst] = {}
    order: list[str] = []

    def resolve(inc: str, from_dir: str):
        cands = [os.path.join(from_dir, inc)]
        for lib in link_libraries:
            cands.append(os.path.join(lib, inc))
        cands.append(inc)
        for c in cands:
            if os.path.isfile(c):
                return os.path.normpath(os.path.abspath(c))
        return None

    root = os.path.normpath(os.path.abspath(path))
    stack = [root]
    main_file: str | None = None
    while stack:
        f = stack.pop(0)
        if f in parsed:
            continue
        try:
            with open(f) as fh:
                src = fh.read()
        except OSError:
            errors.add(Report.error(f"file not found: {f}", "P1006"))
            continue
        fid = file_library.add(f, src)
        try:
            ast = parse_source(src, fid, field_p, no_init)
        except ReportCollection as rc:
            errors.extend(rc)
            continue
        except Report as r:
            errors.add(r)
            continue
        if not _version_ok(ast.version):
            errors.add(
                Report.error(
                    f"file {f} requires compiler version "
                    f"{'.'.join(map(str, ast.version))}, this is "
                    f"{'.'.join(map(str, COMPILER_VERSION))}",
                    "P1003",  # CompilerVersionError
                )
            )
        if ast.version is None:
            warnings.add(
                Report.warning(
                    f"file {f} does not include a `pragma circom` version",
                    "P1004",  # NoCompilerVersionWarning
                )
            )
        if ast.custom_gates:
            # custom templates need >= 2.0.6
            # (parser/src/lib.rs:220-273, CustomGatesVersionError);
            # the no-pragma case gets its own wording in the reference
            # (lib.rs:244-258: "does not include pragma version")
            if ast.version is None:
                if tuple(COMPILER_VERSION) < (2, 0, 6):
                    errors.add(
                        Report.error(
                            f"file {f} does not include pragma version "
                            "and the compiler version (currently "
                            f"{'.'.join(map(str, COMPILER_VERSION))}) "
                            "should be at least 2.0.6 to use custom "
                            "templates",
                            "CG05",
                        )
                    )
            elif tuple(ast.version) < (2, 0, 6):
                errors.add(
                    Report.error(
                        f"file {f} requires at least version 2.0.6 to "
                        f"use custom templates "
                        f"(currently {'.'.join(map(str, ast.version))})",
                        "CG05",
                    )
                )
        parsed[f] = ast
        order.append(f)
        if ast.main is not None:
            if main_file is not None:
                errors.add(
                    Report.error(
                        "multiple main components "
                        f"(in {main_file} and {f})",
                        "P1002",
                    )
                )
            main_file = f
        for inc in ast.includes:
            r = resolve(inc, os.path.dirname(f))
            if r is None:
                errors.add(
                    Report.error(f"include not found: {inc}", "P1014")
                )
            elif r not in parsed:
                stack.append(r)

    if main_file is None and not errors.reports:
        errors.add(Report.error("no main component found", "P1001"))
    if errors.reports:
        raise errors

    functions, templates, buses = {}, {}, {}
    names = {}
    for f in order:
        ast = parsed[f]
        for d in ast.definitions:
            table = (
                functions if isinstance(d, Function)
                else templates if isinstance(d, Template)
                else buses
            )
            if d.name in names:
                # SameFunctionDeclaredTwice / SameTemplateDeclaredTwice /
                # SameSymbolDeclaredTwice (error_code.rs:156-158)
                prev = names[d.name]
                if isinstance(d, Function) and isinstance(prev, Function):
                    dup_code = "T2006"
                elif isinstance(d, Template) and isinstance(prev, Template):
                    dup_code = "T2007"
                else:
                    dup_code = "T2008"
                errors.add(
                    Report.error(
                        f"duplicate definition of symbol '{d.name}'",
                        dup_code,
                    ).add_primary(d.meta.file_id, d.meta.start, d.meta.start + 8)
                )
            names[d.name] = d
            table[d.name] = d
    if errors.reports:
        raise errors

    main_ast = parsed[main_file]
    archive = ProgramArchive(
        file_library=file_library,
        functions=functions,
        templates=templates,
        buses=buses,
        main=main_ast.main,
        main_file_id=main_ast.file_id,
        custom_gates=any(a.custom_gates for a in parsed.values()),
        prime=prime,
        field_p=field_p,
    )
    # desugar anonymous components and tuples (reference:
    # parser/src/lib.rs calls apply_syntactic_sugar after archive build)
    from .sugar import apply_syntactic_sugar

    try:
        apply_syntactic_sugar(archive)
    except Report as r:
        raise ReportCollection([r])
    return archive, warnings

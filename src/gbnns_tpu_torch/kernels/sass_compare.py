"""Compare two copies of the port's CUDA sources as the card compiles them:
the nvcc time of each source and the SASS of every kernel both have.

    PYTHONPATH=src python3 -m gbnns_tpu_torch.kernels.sass_compare OLD_CSRC \\
        [--out DIR]

OLD_CSRC is another checkout's ``src/gbnns_tpu_torch/kernels/csrc`` (an
earlier commit unpacked with ``git archive`` into an ignored directory).
Each tree's libraries are built as ``kernels._build`` builds them, one
nvcc process a source, all of a tree started together, and timed; then
``cuobjdump -sass`` of the two builds is compared kernel by kernel. A kernel
is matched by its demangled name without its parameter list; K1's kernels
gained a last template argument, the epilogue, and ``<..., 0>`` (prescaled,
the only one before) is matched to the old kernel without it. The last line
printed is a JSON summary: build seconds by source and tree, the kernels
compared and those whose SASS differs, and the registers and local memory
(spills) of the kernels only the new tree has. The SASS of each kernel
that differs is written under DIR (``chiprun_out/sass`` by default); the
builds go to a temporary directory. Needs nvcc and cuobjdump: it runs on
the card's machine.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
import time

from gbnns_tpu_torch.kernels import _build

# K1's kernels, whose last template argument (the epilogue) is new
EPILOGUE_KERNELS = ("binned_scan_tc_kernel", "binned_scan_kernel",
                    "binned_scan_wide_kernel")


def build_tree(csrc: pathlib.Path, out: pathlib.Path) -> dict:
    """Build every library of ``csrc`` into ``out`` as ``kernels._build``
    builds them, all nvcc processes at once; returns each library's seconds
    and the tree's wall time."""
    secs = _build.build(_build.libraries(csrc), csrc=csrc, root=out)
    return {"seconds": secs, "wall": max(secs.values(), default=0.0)}


def _tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    return str(pathlib.Path(_build._nvcc()).parent / name)


def demangle(names: list[str]) -> list[str]:
    if not names:
        return []
    out = subprocess.run([_tool("cu++filt")], input="\n".join(names),
                         capture_output=True, text=True, check=True).stdout
    return out.splitlines()


def split_functions(text: str) -> dict[str, str]:
    """``cuobjdump -sass`` (or ``-res-usage``) output → {mangled name: its
    instructions (or its resource line)}, runs of spaces collapsed; headers
    between the fatbins of a library of several sources are left out."""
    blocks: dict[str, list[str]] = {}
    current = None
    for line in text.splitlines():
        m = re.match(r"\s*Function\s*:?\s*(\S+?):?\s*$", line)
        if m:
            current = m.group(1)
            blocks[current] = []
        elif current is not None and (line.strip().startswith("/*")
                                      or "REG:" in line):
            # cuobjdump pads its columns to the widest instruction of the
            # library, so a new kernel can move every line's spacing
            blocks[current].append(" ".join(line.split()))
    return {k: "\n".join(v) for k, v in blocks.items()}


def kernel_key(demangled: str) -> str:
    """A kernel's name without its parameter list, K1's prescaled epilogue
    argument dropped, so that the old and the new names meet."""
    name = demangled.removeprefix("void ")
    for anon in ("(anonymous namespace)::", "<unnamed>::"):
        name = name.replace(anon, "")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):       # the parameter list's "(" at depth 0
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    name = name[:cut].strip()
    if name.startswith(EPILOGUE_KERNELS):
        for last in (", (int)0>", ", 0>"):
            if name.endswith(last):
                return name[:-len(last)] + ">"
    return name


def sass_by_kernel(lib: pathlib.Path, flag: str = "-sass") -> dict[str, str]:
    text = subprocess.run([_tool("cuobjdump"), flag, str(lib)],
                          capture_output=True, text=True, check=True).stdout
    blocks = split_functions(text)
    names = list(blocks)
    return {kernel_key(d): blocks[m] for m, d in zip(names, demangle(names))}


def resources(lib: pathlib.Path) -> dict[str, dict]:
    """{kernel: {"REG": n, "STACK": bytes, "LOCAL": bytes}} from
    ``cuobjdump -res-usage``."""
    out = {}
    for name, body in sass_by_kernel(lib, "-res-usage").items():
        out[name] = {k: int(v) for k, v in
                     re.findall(r"\b(REG|STACK|LOCAL):(\d+)", body)}
    return out


def compare(old_csrc: pathlib.Path, old: pathlib.Path,
            new_csrc: pathlib.Path, new: pathlib.Path,
            out: pathlib.Path) -> dict:
    """Kernel by kernel, the SASS of each library both trees build (the old
    built under ``old``, the new under ``new``); differing kernels' SASS is
    written under ``out``."""
    summary = {}
    for name in _build.libraries(new_csrc):
        if name not in _build.libraries(old_csrc):
            continue
        lib = f"lib{name}.so"
        a = sass_by_kernel(_build.library_path(name, old_csrc, old))
        b = sass_by_kernel(_build.library_path(name, new_csrc, new))
        both = sorted(set(a) & set(b))
        differ = [k for k in both if a[k] != b[k]]
        only_new = sorted(set(b) - set(a))
        res = resources(_build.library_path(name, new_csrc, new))
        d = out / lib
        d.mkdir(parents=True, exist_ok=True)
        for k in differ:
            slug = re.sub(r"[^A-Za-z0-9]+", "_", k)[:120]
            (d / f"{slug}.old.sass").write_text(a[k])
            (d / f"{slug}.new.sass").write_text(b[k])
        summary[lib] = {
            "compared": len(both), "identical": len(both) - len(differ),
            "differ": differ, "only_old": sorted(set(a) - set(b)),
            "only_new": len(only_new),
            "only_new_resources": {k: res.get(k) for k in only_new}}
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old_csrc", type=pathlib.Path)
    ap.add_argument("--out", type=pathlib.Path,
                    default=pathlib.Path("chiprun_out") / "sass")
    args = ap.parse_args(argv)
    builds = {}
    with tempfile.TemporaryDirectory() as tmp:
        for tag, csrc in (("old", args.old_csrc), ("new", _build.CSRC)):
            builds[tag] = build_tree(csrc, pathlib.Path(tmp) / tag)
            print(f"{tag} tree {csrc}: {builds[tag]}", flush=True)
        kernels = compare(args.old_csrc, pathlib.Path(tmp) / "old",
                          _build.CSRC, pathlib.Path(tmp) / "new", args.out)
    for lib, rep in kernels.items():
        print(f"{lib}: {rep['identical']}/{rep['compared']} kernels "
              f"identical; differ {rep['differ']}; only in the new build "
              f"{rep['only_new']}", flush=True)
    print(json.dumps({"builds": builds, "kernels": kernels}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

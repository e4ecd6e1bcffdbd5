"""Registers and spills of every kernel of the port, as `ptxas` reports them.

    python macsa_tpu_torch/csrc/ptxas_report.py [source.cu ...]

Compiles each source (all of `csrc/*.cu` by default) with the build's own
flags plus `-Xptxas -v`, one `nvcc` process a source, all started together,
and prints one line a kernel: registers a thread, bytes of stack frame,
spill stores and spill loads.  A kernel that spills runs, but slower than
its register count says; the tensor-core kernels are written to stay under
their launch bounds without spilling.  Exits 1 if a source does not compile.
Needs `nvcc`; no card.
"""

import re
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
from macsa_tpu_torch.ops import cuda_lib  # noqa: E402


def demangle(names: list) -> list:
    """Kernel names through `cu++filt` where the toolkit has it."""
    tool = Path(cuda_lib.find_nvcc()).with_name("cu++filt")
    if not names or not tool.is_file():
        return names
    out = subprocess.run([str(tool), *names], capture_output=True, text=True)
    lines = out.stdout.splitlines()
    return lines if out.returncode == 0 and len(lines) == len(names) else names


def report(source: Path, text: str) -> None:
    entries = re.findall(
        r"Compiling entry function '(\S+)'.*?(\d+) bytes stack frame, (\d+) bytes spill stores, "
        r"(\d+) bytes spill loads.*?Used (\d+) registers", text, flags=re.S)
    print(f"{source.name}: {len(entries)} kernels")
    for name, (_, stack, stores, loads, regs) in zip(demangle([e[0] for e in entries]), entries):
        # drop the namespace, the casts of template arguments and the parameter list
        short = re.sub(r"\(anonymous namespace\)::|<unnamed>::|\((?:int|bool)\)", "", name)
        short = short.split("(")[0]
        print(f"  {regs:>3} registers, {stack} B stack, {stores} B spill stores, "
              f"{loads} B spill loads  {short}")


def main(argv: list) -> int:
    sources = [Path(a) for a in argv] or sorted(cuda_lib.CSRC.glob("*.cu"))
    nvcc = cuda_lib.find_nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        cmds = [[nvcc, *cuda_lib.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                 str(Path(tmp) / f"{src.stem}.o"), str(src)] for src in sources]
        failed = 0
        for src, proc in zip(sources, cuda_lib._run_all(cmds)):
            if proc.returncode != 0:
                print(f"{src.name}: nvcc failed ({proc.returncode})\n{proc.stdout}\n{proc.stderr}")
                failed = 1
                continue
            report(src, proc.stdout + proc.stderr)
    return failed


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""The harness and its reference load no JAX and nothing of the JAX
package (top-level names compared whole: ``repro_torch`` is not
``repro``), and the reference loads nothing of the program."""
import subprocess
import sys
import textwrap

from _tiny import PB, REPO

CODE = textwrap.dedent("""
    import sys
    sys.path[:0] = [{src!r}, {pb!r}]
    {imports}
    top = {{m.split(".")[0] for m in sys.modules}}
    print(sorted(top & {{"jax", "jaxlib", "flax", "repro", "repro_torch"}}))
""")


def loaded(imports):
    out = subprocess.run(
        [sys.executable, "-c", CODE.format(src=str(REPO / "src"),
                                           pb=str(PB), imports=imports)],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_harness_loads_no_jax():
    got = loaded("import run\nfrom pbench import runner, serve, program")
    assert got == "['repro_torch']"


def test_reference_loads_nothing_of_the_program():
    got = loaded("from reference import model, router\n"
                 "from pbench import counts, traffic, window")
    assert got == "[]"

"""Compile-and-run-everything smoke entry (reference AllMain.hs:15-18).

Runs the three example programs end-to-end on the chosen backend (a name
or a backend object; the card by default) and reports PASS/FAIL for each.

    python -m alchemy_tpu_torch.examples.all_main
"""

from __future__ import annotations


def main(backend="torch") -> bool:
    from alchemy_tpu_torch.examples import arithmetic, homomrlwr, tunnel

    results = {
        "Arithmetic": arithmetic.run(verbose=False, backend=backend),
        "Tunnel": tunnel.run(verbose=False, backend=backend),
        "HomomRLWR": homomrlwr.run(verbose=False, backend=backend),
    }
    for name, ok in results.items():
        print(f"{name}: {'PASS' if ok else 'FAIL'}")
    return all(results.values())


if __name__ == "__main__":
    import sys

    sys.exit(0 if main() else 1)

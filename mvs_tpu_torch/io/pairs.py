"""pair.txt codec: per-reference-view ranked source views.

Format (reference MVSNet/eval.py:82-91, CasMVSNet/colmap2mvsnet.py:435-441):

    <num_views>
    <ref_id_0>
    <N id score id score ...>
    <ref_id_1>
    ...
"""

from __future__ import annotations

from pathlib import Path

__all__ = ["read_pair_file", "write_pair_file"]


def read_pair_file(path) -> list[tuple[int, list[int]]]:
    """Returns [(ref_view, [src_view, ...]), ...] with sources in score order."""
    pairs: list[tuple[int, list[int]]] = []
    with open(path) as f:
        num_viewpoint = int(f.readline())
        for _ in range(num_viewpoint):
            ref_view = int(f.readline().rstrip())
            fields = f.readline().rstrip().split()
            src_views = [int(x) for x in fields[1::2]]
            pairs.append((ref_view, src_views))
    return pairs


def write_pair_file(path, pairs: list[tuple[int, list[tuple[int, float]]]]) -> None:
    """pairs: [(ref_view, [(src_view, score), ...]), ...]."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        f.write(f"{len(pairs)}\n")
        for ref_view, srcs in pairs:
            f.write(f"{ref_view}\n{len(srcs)} ")
            f.write(" ".join(f"{i} {s}" for i, s in srcs) + "\n")

"""The static launch-geometry guard of the port's tunable kernels (K1,
K2 / K2', K9): plain functions of shapes that say why a launch plan
cannot run on a card, before anything is built or launched.

Counterpart of what ``paddle_tpu/analysis/kernelmodel.py`` gives the
JAX tuners (``budget_reason``, the PT006 VMEM clamp of ``_resolve_vb``):
a reason string, or None. Nothing else of the JAX ``analysis`` package
has a counterpart (it lints TPU launches). The arithmetic mirrors the
CUDA sources, each function names the lines it follows, and the CPU
tests hold it against hand counts.

A plan is refused when:

- the dynamic shared memory it needs exceeds the card's opt-in limit
  per block (``Card.smem_optin``: read from the device, 232,448 bytes on
  an H100), less the kernel's static shared arrays where it has them;
- its cluster is wider than ``MAX_CLUSTER`` (8, the portable cluster
  size);
- its grid is wider than the work's tiles (a K2 block without a 16-row
  table tile, a K9 block without a 64-column vocabulary tile);
- it is a K1 tile the library does not compile.

The tuners pass these as ``geom_check``, so a refused candidate is
never built. At launch the resolvers clamp the numeric knobs with the
same arithmetic (``clamp_paged``: K2's splits and stages;
``clamp_logits``: K9's ring and grid) and refuse what no clamp fixes.

``card(device)`` describes a CUDA device from its properties. A CPU
device plans against an H100 SXM's published figures (``H100_SMS``,
``H100_SMEM_OPTIN``), so a CPU run walks the card's candidate lists;
the tuners key every entry by ``autotune.device_key``, so no plan made
for the CPU is ever applied to a card.
"""

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch

__all__ = ["Card", "card", "H100_SMS", "H100_SMEM_OPTIN", "MAX_CLUSTER",
           "K9_WIDTHS", "K9_MAX_STAGES", "K9_STATIC", "k9_smem",
           "logits_reason", "clamp_logits", "PAGED_TILE_ROWS",
           "PAGED_MAX_SPLITS", "PAGED_MAX_STAGES", "paged_smem",
           "paged_reason", "clamp_paged", "flash_tiles", "flash_route",
           "flash_stages", "flash_smem", "flash_reason"]

H100_SMS = 132
H100_SMEM_OPTIN = 232448       # bytes a block may opt in to (sm_90)
MAX_CLUSTER = 8                # the portable cluster size


class Card(NamedTuple):
    """What the guard needs to know of a card."""
    sms: int
    smem_optin: int


_CARDS: Dict[int, Card] = {}


def _smem_optin(idx: int) -> int:
    props = torch.cuda.get_device_properties(idx)
    got = getattr(props, "shared_memory_per_block_optin", None)
    if got:
        return int(got)
    # an older PyTorch: ask the runtime through the launch probe's library
    from paddle_tpu_torch.ops import _build
    lib = _build.load("launch_probe")
    lib.pt_smem_optin.argtypes = [ctypes.c_int]
    lib.pt_smem_optin.restype = ctypes.c_int
    got = lib.pt_smem_optin(idx)
    if got <= 0:
        raise RuntimeError(f"cannot read the shared memory limit of CUDA "
                           f"device {idx} (CUDA error {-got})")
    return got


def card(device) -> Card:
    """The SM count and per-block shared-memory opt-in limit of
    ``device`` (cached per CUDA device); a CPU device gets the H100's."""
    device = torch.device(device)
    if device.type != "cuda":
        return Card(H100_SMS, H100_SMEM_OPTIN)
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _CARDS:
        _CARDS[idx] = Card(
            torch.cuda.get_device_properties(idx).multi_processor_count,
            _smem_optin(idx))
    return _CARDS[idx]


# -- K9: logits_kernel_sm90 (csrc/decode_megakernel.cu) ----------------------

K9_WIDTHS = (8, 16, 32, 64)    # wgmma widths a row group may take
K9_COLS = 64                   # vocabulary columns of a tile
K9_DEPTH = 64                  # depth of a head box
K9_BOX = K9_COLS * K9_DEPTH * 2
K9_MAX_STAGES = 16
# the kernel's static shared arrays (barriers, the rows' best keys and
# flags: about 1 KB) and a margin, kept off the opt-in limit
K9_STATIC = 2048


def k9_smem(n: int, dm: int, stages: int) -> int:
    """Dynamic shared memory of ``logits_kernel_sm90`` (``k9_smem`` in
    the source): n rows of each 64-deep slab of the LayerNormed rows
    (128 bytes a row), ``stages`` head boxes, 1024 bytes of alignment."""
    nk = -(-dm // K9_DEPTH)
    return nk * n * 128 + stages * K9_BOX + 1024


def logits_reason(plan, rows: int, dm: int, vocab: int,
                  crd: Card) -> Optional[str]:
    """Why the tensor-core K9 cannot launch ``plan = (group, n, stages,
    grid)`` over ``rows`` rows of a (vocab, dm) head, or None
    (``pt_mega_logits_sm90``'s checks and the launch's shared memory)."""
    group, n, stages, grid = (int(v) for v in plan)
    tiles = -(-vocab // K9_COLS)
    if n not in K9_WIDTHS:
        return f"n {n} is not one of K9's wgmma widths {K9_WIDTHS}"
    if not 1 <= group <= n:
        return f"a group of {group} rows does not fit a width of {n}"
    if not 1 <= stages <= K9_MAX_STAGES:
        return f"stages {stages} outside 1..{K9_MAX_STAGES}"
    need = k9_smem(n, dm, stages)
    limit = crd.smem_optin - K9_STATIC
    if need > limit:
        return (f"{need} bytes of shared memory (width {n} at d_model "
                f"{dm}, {stages} head boxes) exceed the card's "
                f"{limit} ({crd.smem_optin} less {K9_STATIC} static)")
    if not 1 <= grid <= tiles:
        return (f"a grid of {grid} blocks is wider than the vocabulary's "
                f"{tiles} tiles of {K9_COLS} columns")
    return None


def clamp_logits(plan, dm: int, vocab: int, crd: Card):
    """``plan`` with its ring depth made to fit (1..K9_MAX_STAGES boxes
    within the card's shared memory beside the width's rows) and its grid
    within 1..the vocabulary's tiles; the group and the width as given
    (``logits_reason`` judges them)."""
    group, n, stages, grid = (int(v) for v in plan)
    fit = (crd.smem_optin - K9_STATIC - k9_smem(n, dm, 0)) // K9_BOX
    stages = max(1, min(stages, K9_MAX_STAGES, fit))
    return group, n, stages, max(1, min(grid, -(-vocab // K9_COLS)))


# -- K2 / K2': paged_kernel (csrc/paged_attention.cu, decode_attn.cuh) -------

PAGED_TILE_ROWS = 16           # pool rows of a bulk-copied tile
PAGED_MAX_SPLITS = MAX_CLUSTER
PAGED_MAX_STAGES = 4
_PAGED_WARPS = 4


def paged_smem(stages: int, group: int, d: int, elt: int) -> int:
    """Dynamic shared memory of one ``paged_kernel`` block
    (``dattn::smem_bytes``): the ring of ``stages`` K and V tiles of 16
    rows, reused for the warps' partials, then the block's partial; the
    register group G is ``group`` rounded up to 1, 2, 4 or 8."""
    g = next(v for v in (1, 2, 4, 8) if v >= group)
    ring = stages * 2 * PAGED_TILE_ROWS * d * elt
    partial = g * (d + 2) * 4
    part_off = (max(ring, _PAGED_WARPS * partial) + 15) // 16 * 16
    return part_off + partial


def paged_reason(splits: int, stages: int, max_pages: int, page: int,
                 group: int, d: int, elt: int, crd: Card) -> Optional[str]:
    """Why K2 / K2' cannot launch ``splits`` blocks a (row, kv head)
    cluster with ``stages`` ring slots over a table of max_pages x page
    rows, or None."""
    t = max_pages * page
    if splits > PAGED_MAX_SPLITS:
        return (f"a cluster of {splits} blocks is wider than "
                f"{PAGED_MAX_SPLITS}")
    if splits < 1 or splits & (splits - 1):
        return f"splits {splits} is not a power of two"
    if splits * PAGED_TILE_ROWS > t:
        return (f"{splits} blocks over a table of {t} rows leave a block "
                f"without a {PAGED_TILE_ROWS}-row tile")
    if not 1 <= stages <= PAGED_MAX_STAGES:
        return f"stages {stages} outside 1..{PAGED_MAX_STAGES}"
    need = paged_smem(stages, group, d, elt)
    if need > crd.smem_optin:
        return (f"{need} bytes of shared memory exceed the card's "
                f"{crd.smem_optin}")
    return None


def clamp_paged(splits: int, stages: int, max_pages: int,
                page: int) -> Tuple[int, int]:
    """``(splits, stages)`` made valid: splits the largest power of two
    at most ``splits``, PAGED_MAX_SPLITS and the table's 16-row tiles (at
    least 1); stages within 1..PAGED_MAX_STAGES."""
    cap = max(1, min(int(splits), PAGED_MAX_SPLITS,
                     max_pages * page // PAGED_TILE_ROWS))
    s = 1
    while 2 * s <= cap:
        s *= 2
    return s, max(1, min(int(stages), PAGED_MAX_STAGES))


# -- K1: flash_fwd_sm90 / flash_fwd_kernel (csrc/flash_attention_fwd.cu) -----

_FLASH_SM90_TILES = ((128, 64), (128, 128))    # (query rows, keys)
_FLASH_CORE_TILES = ((64, 32),)
_FLASH_STAGES = {64: 3, 128: 2}                # ring stages a key tile


def flash_route(dtype, d: int) -> str:
    """K1's kernel: ``"sm90"`` (TMA + wgmma) for bf16 with a head dim a
    multiple of 16, else ``"cuda_cores"`` (the FP32-pipe kernel)."""
    return "sm90" if dtype == torch.bfloat16 and d % 16 == 0 \
        else "cuda_cores"


def flash_tiles(dtype, d: int) -> Tuple[Tuple[int, int], ...]:
    """The (block_q, block_k) tiles K1 compiles for this route."""
    return _FLASH_SM90_TILES if flash_route(dtype, d) == "sm90" \
        else _FLASH_CORE_TILES


def flash_stages(block_k: int) -> int:
    """Ring stages of the sm90 instance with ``block_k`` keys a tile."""
    return _FLASH_STAGES[block_k]


def flash_smem(d: int, block_q: int, block_k: int) -> int:
    """Dynamic shared memory of ``flash_fwd_sm90`` (``FwdSmem``): the Q
    tile and ``flash_stages(block_k)`` (K, V) tile pairs as 64-dim boxes
    of 128 bytes a row at the instance's head dim (64 or 128), the
    q / full / empty barriers, 1024 bytes of alignment."""
    dp = 64 if d <= 64 else 128
    stages = flash_stages(block_k)
    q = (dp // 64) * block_q * 128
    kv = (dp // 64) * block_k * 128
    return q + stages * 2 * kv + (1 + 2 * stages) * 8 + 1024


def flash_reason(block_q: int, block_k: int, dtype, d: int,
                 crd: Card) -> Optional[str]:
    """Why K1 cannot launch tile (block_q, block_k) for ``dtype`` at head
    dim ``d``, or None."""
    tiles = flash_tiles(dtype, d)
    if (block_q, block_k) not in tiles:
        return (f"K1's {flash_route(dtype, d)} route compiles the tiles "
                f"{list(tiles)} for {dtype} at head_dim {d}, not "
                f"({block_q}, {block_k})")
    if flash_route(dtype, d) == "sm90":
        need = flash_smem(d, block_q, block_k)
        if need > crd.smem_optin:
            return (f"{need} bytes of shared memory exceed the card's "
                    f"{crd.smem_optin}")
    return None

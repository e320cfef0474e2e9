"""In-framebuffer debug text: a 5x7 bitmap font stamped into the rendered
frame on device.

The reference draws its Debug Overlay with ImGui into the swapchain image
(sc_imgui.cpp:186-629); this renderer's framebuffer is a device array, so
the overlay becomes one masked blend.  Glyphs cover what the telemetry
overlay prints (scx.telemetry.snapshots.format_overlay): digits, uppercase
letters (input is uppercased), and punctuation.  Unknown glyphs render as
blanks.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

GLYPH_W, GLYPH_H = 5, 7
_CELL_W, _CELL_H = 6, 9  # 1px x / 2px y spacing

# 5x7 string-art font ('#' = lit). Public-domain shapes, hand-authored.
_GLYPHS = {
    " ": ["     "] * 7,
    "0": [" ### ", "#   #", "#  ##", "# # #", "##  #", "#   #", " ### "],
    "1": ["  #  ", " ##  ", "  #  ", "  #  ", "  #  ", "  #  ", " ### "],
    "2": [" ### ", "#   #", "    #", "  ## ", " #   ", "#    ", "#####"],
    "3": [" ### ", "#   #", "    #", "  ## ", "    #", "#   #", " ### "],
    "4": ["   # ", "  ## ", " # # ", "#  # ", "#####", "   # ", "   # "],
    "5": ["#####", "#    ", "#### ", "    #", "    #", "#   #", " ### "],
    "6": [" ### ", "#    ", "#    ", "#### ", "#   #", "#   #", " ### "],
    "7": ["#####", "    #", "   # ", "  #  ", " #   ", " #   ", " #   "],
    "8": [" ### ", "#   #", "#   #", " ### ", "#   #", "#   #", " ### "],
    "9": [" ### ", "#   #", "#   #", " ####", "    #", "    #", " ### "],
    "A": [" ### ", "#   #", "#   #", "#####", "#   #", "#   #", "#   #"],
    "B": ["#### ", "#   #", "#   #", "#### ", "#   #", "#   #", "#### "],
    "C": [" ### ", "#   #", "#    ", "#    ", "#    ", "#   #", " ### "],
    "D": ["#### ", "#   #", "#   #", "#   #", "#   #", "#   #", "#### "],
    "E": ["#####", "#    ", "#    ", "#### ", "#    ", "#    ", "#####"],
    "F": ["#####", "#    ", "#    ", "#### ", "#    ", "#    ", "#    "],
    "G": [" ### ", "#   #", "#    ", "# ###", "#   #", "#   #", " ### "],
    "H": ["#   #", "#   #", "#   #", "#####", "#   #", "#   #", "#   #"],
    "I": [" ### ", "  #  ", "  #  ", "  #  ", "  #  ", "  #  ", " ### "],
    "J": ["  ###", "   # ", "   # ", "   # ", "   # ", "#  # ", " ##  "],
    "K": ["#   #", "#  # ", "# #  ", "##   ", "# #  ", "#  # ", "#   #"],
    "L": ["#    ", "#    ", "#    ", "#    ", "#    ", "#    ", "#####"],
    "M": ["#   #", "## ##", "# # #", "# # #", "#   #", "#   #", "#   #"],
    "N": ["#   #", "##  #", "# # #", "#  ##", "#   #", "#   #", "#   #"],
    "O": [" ### ", "#   #", "#   #", "#   #", "#   #", "#   #", " ### "],
    "P": ["#### ", "#   #", "#   #", "#### ", "#    ", "#    ", "#    "],
    "Q": [" ### ", "#   #", "#   #", "#   #", "# # #", "#  # ", " ## #"],
    "R": ["#### ", "#   #", "#   #", "#### ", "# #  ", "#  # ", "#   #"],
    "S": [" ####", "#    ", "#    ", " ### ", "    #", "    #", "#### "],
    "T": ["#####", "  #  ", "  #  ", "  #  ", "  #  ", "  #  ", "  #  "],
    "U": ["#   #", "#   #", "#   #", "#   #", "#   #", "#   #", " ### "],
    "V": ["#   #", "#   #", "#   #", "#   #", "#   #", " # # ", "  #  "],
    "W": ["#   #", "#   #", "#   #", "# # #", "# # #", "## ##", "#   #"],
    "X": ["#   #", "#   #", " # # ", "  #  ", " # # ", "#   #", "#   #"],
    "Y": ["#   #", "#   #", " # # ", "  #  ", "  #  ", "  #  ", "  #  "],
    "Z": ["#####", "    #", "   # ", "  #  ", " #   ", "#    ", "#####"],
    ".": ["     ", "     ", "     ", "     ", "     ", " ##  ", " ##  "],
    ",": ["     ", "     ", "     ", "     ", " ##  ", "  #  ", " #   "],
    ":": ["     ", " ##  ", " ##  ", "     ", " ##  ", " ##  ", "     "],
    ";": ["     ", " ##  ", " ##  ", "     ", " ##  ", "  #  ", "     "],
    "-": ["     ", "     ", "     ", "#####", "     ", "     ", "     "],
    "+": ["     ", "  #  ", "  #  ", "#####", "  #  ", "  #  ", "     "],
    "/": ["    #", "    #", "   # ", "  #  ", " #   ", "#    ", "#    "],
    "(": ["   # ", "  #  ", " #   ", " #   ", " #   ", "  #  ", "   # "],
    ")": [" #   ", "  #  ", "   # ", "   # ", "   # ", "  #  ", " #   "],
    "%": ["##  #", "##  #", "   # ", "  #  ", " #   ", "#  ##", "#  ##"],
    "#": [" # # ", " # # ", "#####", " # # ", "#####", " # # ", " # # "],
    "_": ["     ", "     ", "     ", "     ", "     ", "     ", "#####"],
    "=": ["     ", "     ", "#####", "     ", "#####", "     ", "     "],
    "[": [" ### ", " #   ", " #   ", " #   ", " #   ", " #   ", " ### "],
    "]": [" ### ", "   # ", "   # ", "   # ", "   # ", "   # ", " ### "],
    "'": ["  #  ", "  #  ", "     ", "     ", "     ", "     ", "     "],
    ">": [" #   ", "  #  ", "   # ", "    #", "   # ", "  #  ", " #   "],
    "<": ["   # ", "  #  ", " #   ", "#    ", " #   ", "  #  ", "   # "],
    "|": ["  #  ", "  #  ", "  #  ", "  #  ", "  #  ", "  #  ", "  #  "],
}


@functools.lru_cache(maxsize=1)
def _font_table() -> np.ndarray:
    """[96, GLYPH_H, GLYPH_W] f32 bitmap for ASCII 32..127."""
    table = np.zeros((96, GLYPH_H, GLYPH_W), np.float32)
    for ch, rows in _GLYPHS.items():
        g = np.asarray(
            [[1.0 if c == "#" else 0.0 for c in row.ljust(GLYPH_W)] for row in rows],
            np.float32,
        )
        table[ord(ch) - 32] = g
    return table


def text_to_codes(text: str, max_cols: int) -> np.ndarray:
    """Host: multi-line string -> [rows, max_cols] i32 font indices."""
    lines = text.upper().splitlines() or [""]
    rows = len(lines)
    codes = np.zeros((rows, max_cols), np.int32)  # 0 == space
    for r, line in enumerate(lines):
        for c, ch in enumerate(line[:max_cols]):
            v = ord(ch) - 32
            codes[r, c] = v if 0 <= v < 96 else 0
    return codes


def stamp_text(rgb, codes, x: int = 4, y: int = 4,
               color=(1.0, 1.0, 1.0), bg_alpha: float = 0.55):
    """Blend the glyph block into rgb [H,W,3] at (x, y).

    One [region] gather over the font table + two masked blends; jit-safe
    for a fixed codes shape (the overlay re-jits only when the line count
    changes)."""
    font = jnp.asarray(_font_table())
    rows, cols = codes.shape
    rh, rw = rows * _CELL_H, cols * _CELL_W
    h, w = rgb.shape[0], rgb.shape[1]
    rh = min(rh, h - y)
    rw = min(rw, w - x)
    yy = jnp.arange(rh)
    xx = jnp.arange(rw)
    cell_r = yy // _CELL_H
    cell_c = xx // _CELL_W
    gy = yy % _CELL_H
    gx = xx % _CELL_W
    code = jnp.asarray(codes)[cell_r[:, None], cell_c[None, :]]
    in_glyph = (gy[:, None] < GLYPH_H) & (gx[None, :] < GLYPH_W)
    lit = font[
        code,
        jnp.minimum(gy, GLYPH_H - 1)[:, None],
        jnp.minimum(gx, GLYPH_W - 1)[None, :],
    ] * in_glyph
    region = rgb[y:y + rh, x:x + rw]
    dimmed = region * (1.0 - bg_alpha)
    out = jnp.where(
        lit[..., None] > 0.5, jnp.asarray(color, rgb.dtype), dimmed
    )
    return rgb.at[y:y + rh, x:x + rw].set(out)

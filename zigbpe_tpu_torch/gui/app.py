"""Interactive shell — the reference GUI's analogue (a copy of
``zigbpe_tpu/gui/app.py`` whose tokenizer lives on a chosen device).

The reference ships a dormant raylib window (tokenizer_gui.zig:5-76): a
text-input box and a display box that mirrors the input; it never calls the
tokenizer and its only call site is commented out (main.zig:42). The
TPU framework's analogue is a curses terminal UI with the same two-box
layout and input handling (printable ASCII + backspace,
tokenizer_gui.zig:35-50); unlike the reference it can optionally tokenize
live when given a merge table.
"""

from __future__ import annotations

from typing import Optional

MAX_INPUT = 256  # reference input buffer size (tokenizer_gui.zig:9)


def run(merges_path: Optional[str] = None, backend: str = "host", device="cpu") -> None:
    """Run the interactive shell. ESC quits (the reference's window-close
    analogue). With ``merges_path``, the display box shows the token ids of
    the input, encoded by ``backend`` with a tokenizer on ``device``,
    instead of a plain mirror."""
    import curses

    tokenizer = None
    if merges_path:
        from ..models.basic_tokenizer import BasicTokenizer

        tokenizer = BasicTokenizer.from_merges_file(merges_path, device=device)

    def main(stdscr) -> None:
        curses.curs_set(1)
        stdscr.nodelay(False)
        buf: list[str] = []
        while True:
            stdscr.erase()
            h, w = stdscr.getmaxyx()
            text = "".join(buf)
            stdscr.addstr(0, 0, "zigbpe-tpu tokenizer shell (ESC to quit)"[: w - 1])
            stdscr.addstr(2, 0, "Input:"[: w - 1])
            stdscr.addstr(3, 2, text[-(w - 4):])
            stdscr.addstr(5, 0, ("Tokens:" if tokenizer else "Display:")[: w - 1])
            shown = (
                " ".join(str(t) for t in tokenizer.encode(text, backend=backend))
                if tokenizer
                else text
            )
            stdscr.addstr(6, 2, shown[-(w - 4):])
            stdscr.refresh()

            ch = stdscr.getch()
            if ch == 27:  # ESC
                return
            if ch in (curses.KEY_BACKSPACE, 127, 8):
                if buf:
                    buf.pop()
            elif 32 <= ch < 127 and len(buf) < MAX_INPUT:
                buf.append(chr(ch))

    curses.wrapper(main)

"""Display modes and buffered rendering for explain / whyNot output
(counterpart of hyperspace_tpu/analysis/display.py).

Reference parity: plananalysis/DisplayMode.scala:24-89 (ConsoleMode /
PlainTextMode / HTMLMode with conf-overridable highlight tags, per-mode
newline and begin/end wrapping) and plananalysis/BufferStream.scala:23-83
(write / writeLine / highlight over a mode-aware buffer). Both packages
keep the same three modes and conf keys; HTML mode additionally escapes
payload text, which the reference leaves to the notebook frontend.
"""

from __future__ import annotations

import html as _html
from dataclasses import dataclass
from typing import TYPE_CHECKING

from .. import constants as C
from ..exceptions import HyperspaceError

if TYPE_CHECKING:
    from ..session import HyperspaceSession


@dataclass(frozen=True)
class Tag:
    """Open/close marker pair (ref: DisplayMode.scala:89)."""

    open: str
    close: str


class DisplayMode:
    """How explain output renders: newline convention, whole-output
    wrapping, and the highlight tags marking index-bearing plan lines.
    Conf-set begin/end tags override the mode default only when BOTH are
    non-empty (ref: DisplayMode.getHighlightTagOrElse:47-56)."""

    name = "plaintext"
    newline = "\n"
    begin_end_tag = Tag("", "")
    _default_highlight = Tag("", "")

    def __init__(self, display_conf: dict[str, str] | None = None):
        conf = display_conf or {}
        begin = conf.get(C.HIGHLIGHT_BEGIN_TAG, "")
        end = conf.get(C.HIGHLIGHT_END_TAG, "")
        self.highlight_tag = (
            Tag(begin, end) if begin and end else self._default_highlight
        )

    def escape(self, s: str) -> str:
        """Payload-text escaping; identity except in HTML mode."""
        return s


class PlainTextMode(DisplayMode):
    """Markers that survive any text sink (ref: DisplayMode.scala:73-78)."""

    name = "plaintext"
    _default_highlight = Tag("<----", "---->")


class ConsoleMode(DisplayMode):
    """ANSI green-background highlight (ref: DisplayMode.scala:82-87)."""

    name = "console"
    _default_highlight = Tag("\033[42m", "\033[0m")


class HTMLMode(DisplayMode):
    """Notebook-displayable output (ref: DisplayMode.scala:61-71)."""

    name = "html"
    newline = "<br>"
    begin_end_tag = Tag("<pre>", "</pre>")
    _default_highlight = Tag('<b style="background:LightGreen">', "</b>")

    def escape(self, s: str) -> str:
        return _html.escape(s, quote=False)


_MODES = {
    "plaintext": PlainTextMode,
    "console": ConsoleMode,
    "html": HTMLMode,
}


def display_mode_for(session: "HyperspaceSession") -> DisplayMode:
    """Build the conf-selected display mode (ref: PlanAnalyzer's mode
    dispatch over IndexConstants.DISPLAY_MODE; unknown names raise, matching
    HyperspaceException there)."""
    name = session.conf.display_mode
    cls = _MODES.get(name)
    if cls is None:
        raise HyperspaceError(
            f"Unsupported display mode: {name} (supported: {sorted(_MODES)})"
        )
    conf = {
        k: str(session.get_conf(k) or "")
        for k in (C.HIGHLIGHT_BEGIN_TAG, C.HIGHLIGHT_END_TAG)
    }
    return cls(conf)


class BufferStream:
    """Mode-aware output buffer (ref: BufferStream.scala:23-83): lines are
    joined with the mode's newline, highlighted spans get the mode's tags,
    and the final render wraps everything in the mode's begin/end tag."""

    def __init__(self, mode: DisplayMode):
        self.mode = mode
        self._parts: list[str] = []

    def write(self, s: str = "") -> "BufferStream":
        self._parts.append(self.mode.escape(s))
        return self

    def write_line(self, s: str = "") -> "BufferStream":
        self._parts.append(self.mode.escape(s) + self.mode.newline)
        return self

    def highlight(self, s: str) -> "BufferStream":
        tag = self.mode.highlight_tag
        self._parts.append(tag.open + self.mode.escape(s) + tag.close)
        return self

    def highlight_line(self, s: str) -> "BufferStream":
        return self.highlight(s).write_line()

    def write_block(self, text: str) -> "BufferStream":
        """Write a multi-line plain-text block line by line (keeps the
        mode's newline convention — critical for HTML output)."""
        for line in text.splitlines():
            self.write_line(line)
        return self

    def render(self) -> str:
        tag = self.mode.begin_end_tag
        return tag.open + "".join(self._parts) + tag.close

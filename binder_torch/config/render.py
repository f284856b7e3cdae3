"""Config-template renderer — the config-agent/SAPI analog.

The reference's ``etc/config.json`` is not hand-written: config-agent
renders it from SAPI metadata through a mustache template with
Triton-vs-Manta branching (``sapi_manifests/binder/manifest.json:1-4``,
``sapi_manifests/binder/template:1-37`` — the presence of a
``dns_domain`` key selects the Triton branch, which alone carries the
``recursion``/UFDS block).  This module provides the same capability for
the rebuild's deployment glue: a from-scratch renderer for the mustache
subset those templates actually use, plus the manifest convention
(template + output path) driven by ``bin/binder-config-render``.

Supported mustache constructs (exactly what the reference templates
need — this is not a general mustache engine):

- ``{{key}}``           — HTML-escaped interpolation
- ``{{{key}}}``         — raw interpolation
- ``{{#key}}…{{/key}}`` — section: rendered when `key` is truthy; for a
                          list value, rendered once per element with the
                          element pushed onto the context stack
- ``{{^key}}…{{/key}}`` — inverted section: rendered when `key` is
                          falsy/absent
- ``{{! comment}}``     — dropped (may span lines)
- dotted names (``auto.ZONENAME``) resolve through nested dicts

Missing keys render as empty strings, like mustache.
"""
from __future__ import annotations

import html
import json
import re
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["render", "render_manifest", "TemplateError"]

_TAG = re.compile(r"\{\{\{\s*([^}]+?)\s*\}\}\}|\{\{\s*([!#^/]?)\s*([^}]*?)\s*\}\}",
                  re.S)


class TemplateError(Exception):
    """Malformed template (unbalanced or mismatched sections)."""


def _lookup(stack: List[Any], dotted: str) -> Any:
    """Resolve a (possibly dotted) name against the context stack,
    innermost first — standard mustache scoping."""
    head = dotted.split(".", 1)[0]
    for frame in reversed(stack):
        if isinstance(frame, dict) and head in frame:
            value: Any = frame
            for part in dotted.split("."):
                if isinstance(value, dict) and part in value:
                    value = value[part]
                else:
                    return None
            return value
    return None


def _parse(template: str) -> List[Tuple]:
    """Tokenize into a nested tree: ('text', s) | ('var', name, raw) |
    ('section', name, inverted, children)."""
    root: List[Tuple] = []
    stack: List[Tuple[str, List[Tuple]]] = [("", root)]
    pos = 0
    for m in _TAG.finditer(template):
        if m.start() > pos:
            stack[-1][1].append(("text", template[pos:m.start()]))
        pos = m.end()
        if m.group(1) is not None:              # {{{raw}}}
            stack[-1][1].append(("var", m.group(1), True))
            continue
        sigil, name = m.group(2), m.group(3).strip()
        if sigil == "!":
            continue                            # comment
        if sigil in ("#", "^"):
            children: List[Tuple] = []
            stack[-1][1].append(("section", name, sigil == "^", children))
            stack.append((name, children))
        elif sigil == "/":
            if len(stack) == 1 or stack[-1][0] != name:
                raise TemplateError(f"unexpected {{{{/{name}}}}}")
            stack.pop()
        else:
            stack[-1][1].append(("var", name, False))
    if len(stack) != 1:
        raise TemplateError(f"unclosed section {{{{#{stack[-1][0]}}}}}")
    if pos < len(template):
        stack[-1][1].append(("text", template[pos:]))
    return root


def _render_nodes(nodes: List[Tuple], stack: List[Any], out: List[str]) -> None:
    for node in nodes:
        kind = node[0]
        if kind == "text":
            out.append(node[1])
        elif kind == "var":
            value = _lookup(stack, node[1])
            if value is None:
                continue
            s = value if isinstance(value, str) else json.dumps(value) \
                if isinstance(value, (dict, list)) else str(value)
            out.append(s if node[2] else html.escape(s, quote=False))
        else:  # section
            _, name, inverted, children = node
            value = _lookup(stack, name)
            # mustache truthiness: absent / false / "" / empty list are
            # falsy, but an empty hash still renders its section
            truthy = not (value is None or value is False
                          or value == "" or value == [])
            if inverted:
                if not truthy:
                    _render_nodes(children, stack, out)
            elif truthy:
                frames = value if isinstance(value, list) else [value]
                for frame in frames:
                    stack.append(frame)
                    _render_nodes(children, stack, out)
                    stack.pop()


def render(template: str, metadata: Dict[str, Any]) -> str:
    out: List[str] = []
    _render_nodes(_parse(template), [metadata], out)
    return "".join(out)


def render_manifest(manifest_path: str, metadata: Dict[str, Any],
                    template_path: Optional[str] = None,
                    output_path: Optional[str] = None) -> str:
    """Render per the manifest convention: a JSON file with ``name`` and
    ``path`` (the output location) sitting next to a ``template`` file
    (reference ``sapi_manifests/binder/manifest.json``).  Returns the
    rendered text; writes it to `output_path` (or the manifest's
    ``path``) unless that is None and the manifest has no path."""
    import os
    with open(manifest_path) as f:
        manifest = json.load(f)
    tpath = template_path or os.path.join(
        os.path.dirname(manifest_path), "template")
    with open(tpath) as f:
        template = f.read()
    rendered = render(template, metadata)
    dest = output_path or manifest.get("path")
    if dest:
        os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
        with open(dest, "w") as f:
            f.write(rendered)
    return rendered

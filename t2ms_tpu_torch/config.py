"""Config: the per-sport ``config.yaml`` merged into the CLIs' arguments,
reference-compatible path derivation and the framework's environment
knobs (counterpart of t2ms_tpu/config.py).

The reference layers config.yaml onto argparse via utils.get_cfg
(reference utils.py:38-60), flattening per-sport keys
(features/flow_dim/input_dim/dataset/vae/diffusion) into the args
namespace, and derives checkpoint and generation directories from
``{backbone}_{denoiser}_{dataset}...`` tuples (train.py:153-157,
mytrain.py:115-116, infer.py:144-146, myinfer.py:240-243); the port keeps
those keys and schemas, so its artifacts land where the JAX package's do.

The card's machine has no YAML library, so ``read_yaml_subset`` reads the
part of YAML that the repository's ``config.yaml`` uses, and refuses the
rest with the line it stopped at.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import re
from typing import List, Optional, Tuple

__all__ = ["get_cfg", "read_yaml_subset", "denoiser_ckpt_dir",
           "generation_dir", "t2s_pretrained_dir", "motion_pretrained_dir",
           "FrameworkConfig"]


# ------------------------------------------------------ the YAML subset

_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)\Z")
# scalars that YAML 1.1 (PyYAML's safe loader) resolves to a type other
# than str or a plain decimal int: bool, float, other ints, null,
# timestamp, merge and value keys
_OTHER_TYPES = re.compile(r"""(?:
    yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF
  | [-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
  | \.[0-9_]+(?:[eE][-+][0-9]+)?
  | [-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
  | [-+]?\.(?:inf|Inf|INF) | \.(?:nan|NaN|NAN)
  | [-+]?0b[0-1_]+ | [-+]?0[0-7_]+ | [-+]?(?:0|[1-9][0-9_]*)
  | [-+]?0x[0-9a-fA-F_]+ | [-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+
  | ~ | null | Null | NULL
  | [0-9]{4}-[0-9]{2}-[0-9]{2}
  | [0-9]{4}-[0-9]{1,2}-[0-9]{1,2}(?:[Tt]|[ \t]+)[0-9]{1,2}:[0-9]{2}:[0-9]{2}
    (?:\.[0-9]*)?(?:[ \t]*(?:Z|[-+][0-9]{1,2}(?::[0-9]{2})?))?
  | <<  | =
)\Z""", re.X)
# characters that open something other than a plain scalar
_INDICATORS = set("-?:,[]{}#&*!|>'\"%@`")


class _Line:
    __slots__ = ("no", "indent", "text")

    def __init__(self, no: int, indent: int, text: str):
        self.no, self.indent, self.text = no, indent, text


def _fail(line, why: str):
    no = line.no if isinstance(line, _Line) else line
    raise ValueError(f"config YAML line {no}: {why} (the port reads "
                     f"block mappings, sequences of one-key mappings, "
                     f"int and plain-string scalars and # comments)")


def _lines(text: str) -> List[_Line]:
    out = []
    for no, raw in enumerate(text.splitlines(), start=1):
        body = raw.rstrip()
        stripped = body.lstrip(" ")
        if stripped.startswith("\t") or "\t" in body[:len(body)
                                                     - len(stripped)]:
            _fail(no, "a tab in the indentation")
        # a comment starts at '#' at the line's start or after a blank
        cut = re.search(r"(?:^|[ \t])#", stripped)
        if cut is not None:
            stripped = stripped[:cut.start()].rstrip()
        if not stripped:
            continue
        if stripped in ("---", "...") or stripped.startswith("%"):
            _fail(no, "a document marker or directive")
        out.append(_Line(no, len(body) - len(body.lstrip(" ")), stripped))
    return out


def _scalar(line: _Line, text: str):
    """A plain scalar: a decimal int or a string."""
    if _INT.match(text):
        return int(text)
    if not text or text[0] in _INDICATORS and not (
            text[0] in "-?:" and len(text) > 1 and text[1] != " "):
        _fail(line, f"{text!r} is not a plain scalar")
    if _OTHER_TYPES.match(text):
        _fail(line, f"{text!r} would load as a bool, float, null or "
                    f"timestamp")
    if ": " in text or text.endswith(":") or " #" in text:
        _fail(line, f"{text!r} holds a mapping indicator")
    return text


def _split_key(line: _Line, text: str) -> Tuple[object, str]:
    """``key: value`` or ``key:`` -> (key, value text, '' when absent)."""
    m = re.match(r"(.*?):(?: +(.*))?\Z", text)
    if m is None or not m.group(1):
        _fail(line, f"{text!r} is not a 'key: value' line")
    key = _scalar(line, m.group(1).rstrip())
    return key, (m.group(2) or "")


def _block(lines: List[_Line], i: int, indent: int):
    """Parse the block whose lines start at ``lines[i]`` with ``indent``;
    -> (node, index of the first line after it)."""
    if lines[i].text == "-" or lines[i].text.startswith("- "):
        return _sequence(lines, i, indent)
    return _mapping(lines, i, indent)


def _sequence(lines, i, indent):
    items = []
    while i < len(lines) and lines[i].indent == indent:
        line = lines[i]
        if not line.text.startswith("- "):
            break
        rest = line.text[2:].strip()
        if i + 1 < len(lines) and lines[i + 1].indent > indent:
            _fail(lines[i + 1], "a sequence item spans lines")
        if re.match(r".*?:(?: |\Z)", rest):
            key, value = _split_key(line, rest)
            if not value:
                _fail(line, "a sequence item's mapping has no value")
            items.append({key: _scalar(line, value)})
        else:
            items.append(_scalar(line, rest))
        i += 1
    return items, i


def _mapping(lines, i, indent):
    out = {}
    while i < len(lines) and lines[i].indent == indent:
        line = lines[i]
        if line.text.startswith("- ") or line.text == "-":
            _fail(line, "a sequence item inside a mapping")
        key, value = _split_key(line, line.text)
        if key in out:
            _fail(line, f"the key {key!r} repeats")
        i += 1
        if value:
            out[key] = _scalar(line, value)
            continue
        nxt = lines[i] if i < len(lines) else None
        if nxt is not None and (nxt.indent > indent or (
                nxt.indent == indent and (nxt.text.startswith("- ")
                                          or nxt.text == "-"))):
            out[key], i = _block(lines, i, nxt.indent)
        else:
            _fail(line, f"the key {key!r} has no value")
    if i < len(lines) and lines[i].indent > indent:
        _fail(lines[i], "an indentation that matches no block")
    return out, i


def read_yaml_subset(text: str) -> dict:
    """Read the YAML that the repository's ``config.yaml`` is written in:
    ``#`` comments (whole lines and line ends), block mappings nested by
    indentation, int keys, sequences of one-key mappings (``- name:
    bar_x``) or scalars, and int or plain-string scalars. The result is
    what ``yaml.safe_load`` gives for such a file. Anything else (flow
    collections, quotes, anchors, block scalars, floats, bools, nulls,
    tabs, repeated keys, multi-line items) raises ``ValueError`` naming
    the line."""
    lines = _lines(text)
    if not lines:
        raise ValueError("config YAML is empty")
    if lines[0].indent:
        _fail(lines[0], "the document does not start at column 0")
    node, i = _mapping(lines, 0, 0)
    if i < len(lines):
        _fail(lines[i], "an indentation that matches no block")
    return node


def get_cfg(args: argparse.Namespace) -> argparse.Namespace:
    """Merge the per-sport section of ``args.config`` into ``args``.
    Mirrors reference utils.py:38-60 (same keys, same defaults)."""
    with open(args.config, "r", encoding="utf-8") as f:
        config = read_yaml_subset(f.read())
    args.dataset_root = config.get("dataset_root", "./Data")
    args.general_seed = config.get("general_seed", 2025)

    cfg = config[args.dataset_name]
    args.features = [feature[0]["name"] for feature in cfg["features"].values()]
    args.flow_dim = cfg.get("flow_dim", 128)
    args.input_dim = cfg.get("input_dim", 10)
    args.split_base_num = cfg["dataset"].get("split_base_num", 36)
    args.caption = cfg["dataset"].get("caption", "Caption_explain_no_barbell")

    vae = cfg.get("vae", {})
    args.d_ff = vae.get("d_ff", 64)
    args.num_encoder_layers = vae.get("num_encoder_layers", 128)
    args.num_decoder_layers = vae.get("num_decoder_layers", 128)
    args.num_heads = vae.get("num_heads", 8)
    args.embedding_dim = vae.get("embedding_dim", 64)
    args.pretrained_epc = vae.get("epoch", 80000)
    # conv-VAE keys (deadlift section of reference config.yaml:96-98)
    args.block_hidden_size = vae.get("block_hidden_size", 128)
    args.num_residual_layers = vae.get("num_residual_layers", 3)
    args.res_hidden_size = vae.get("res_hidden_size", 256)

    diff = cfg.get("diffusion", {})
    args.denoiser = diff.get("denoiser", "DiT")
    args.backbone = diff.get("backbone", "flowmatching")
    return args


# ------------------------------------------------------ artifact paths

def denoiser_ckpt_dir(save_path: str, backbone: str, denoiser: str,
                      dataset_name: str, caption: Optional[str] = None,
                      pretrained_epc: Optional[int] = None) -> str:
    """T2S: {save}/checkpoints/{backbone}_{denoiser}_{dataset} (train.py:157).
    T2MS adds _{caption}_{pretrained_epc} (mytrain.py:115)."""
    if caption is None:
        name = f"{backbone}_{denoiser}_{dataset_name}"
    else:
        name = f"{backbone}_{denoiser}_{dataset_name}_{caption}_{pretrained_epc}"
    return os.path.join(save_path, "checkpoints", name)


def generation_dir(save_path: str, backbone: str, denoiser: str,
                   dataset_name: str, cfg_scale, total_step) -> str:
    """{save}/generation/{backbone}_{denoiser}_{dataset}_{cfg}_{steps}
    (infer.py:146, myinfer.py:243)."""
    name = f"{backbone}_{denoiser}_{dataset_name}_{cfg_scale}_{total_step}"
    return os.path.join(save_path, "generation", name)


def t2s_pretrained_dir(dataset_name: str, epochs: int = 2000) -> str:
    """VAE dir for the T2S track: results/saved_pretrained_models/
    dataset{root}_epoch{N} (train.py:155-156)."""
    root = dataset_name.split("_")[0]
    return os.path.join("results", "saved_pretrained_models",
                        f"dataset{root}_epoch{epochs}")


def motion_pretrained_dir(split_base_num: int, dataset_name: str,
                          pretrained_epc: int) -> str:
    """VAE dir for the motion track: {split}_{sport}_epoch{N}
    (mytrain.py:116)."""
    return os.path.join("results", "saved_pretrained_models",
                        f"{split_base_num}_{dataset_name}_epoch{pretrained_epc}")


@dataclasses.dataclass
class FrameworkConfig:
    """Knobs read from the environment by the CLIs."""
    profile_dir: Optional[str] = None   # torch.profiler trace output

    @classmethod
    def from_env(cls) -> "FrameworkConfig":
        return cls(profile_dir=os.environ.get("T2MS_PROFILE_DIR") or None)

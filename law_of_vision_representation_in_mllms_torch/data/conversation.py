"""Conversation templates (`llava/conversation.py:221-393`).

Each template renders a list of (role, message) turns into (a) the full
prompt string and (b) a segment list [(text, is_target)] used for label
masking — a cleaner contract than the reference's post-hoc length arithmetic
(`train.py:472-508`), with the same effective labels: only assistant
responses (plus their closing separator) are supervised.

Templates used by the pipeline: `plain` for stage-1 pretraining
(caption-only, `pretrain.sh:11`), `v1` (vicuna) for stage-2 finetune and
eval (`finetune.sh:12`), plus llama_2 / chatml / v0 for parity.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

IMAGE_PLACEHOLDER = "<image>"


@dataclasses.dataclass(frozen=True)
class Conversation:
    name: str
    system: str
    roles: Tuple[str, str]
    sep_style: str                  # plain | two | llama_2 | chatml | single
    sep: str = "\n"
    sep2: str = ""

    def render(self, turns: List[Tuple[str, str]]
               ) -> List[Tuple[str, bool]]:
        """turns: [(role, text)] with roles alternating human/gpt.
        Returns [(segment_text, is_target)]."""
        segs: List[Tuple[str, bool]] = []
        if self.sep_style == "plain":
            # stage 1: <image>\n + caption + sep  (`train.py:583-603`)
            assert len(turns) == 2
            segs.append((turns[0][1], False))
            segs.append((turns[1][1] + self.sep, True))
            return segs
        if self.sep_style == "two":
            segs.append((self.system + self.sep, False))
            for i, (role, text) in enumerate(turns):
                if i % 2 == 0:
                    segs.append((f"{self.roles[0]}: {text} ", False))
                    segs.append((f"{self.roles[1]}:", False))
                else:
                    segs.append((f" {text}{self.sep2}", True))
            return segs
        if self.sep_style == "llama_2":
            sys_txt = f"<<SYS>>\n{self.system}\n<</SYS>>\n\n"
            for i, (role, text) in enumerate(turns):
                if i % 2 == 0:
                    prefix = sys_txt if i == 0 else ""
                    segs.append((f"[INST] {prefix}{text} [/INST]", False))
                else:
                    segs.append((f" {text} </s>", True))
            return segs
        if self.sep_style == "chatml":
            segs.append((self.system + self.sep, False))
            for i, (role, text) in enumerate(turns):
                r = self.roles[i % 2]
                if i % 2 == 0:
                    segs.append((f"{r}\n{text}{self.sep}", False))
                else:
                    segs.append((f"{r}\n", False))
                    segs.append((f"{text}{self.sep}", True))
            return segs
        if self.sep_style == "single":
            segs.append((self.system + self.sep, False))
            for i, (role, text) in enumerate(turns):
                r = self.roles[i % 2]
                if i % 2 == 0:
                    segs.append((f"{r}: {text}{self.sep}", False))
                else:
                    segs.append((f"{r}: ", False))
                    segs.append((f"{text}{self.sep}", True))
            return segs
        raise ValueError(self.sep_style)

    def prompt_for_generation(self, turns: List[Tuple[str, str]]) -> str:
        """Render with an empty final assistant slot (eval-time prompts,
        `lmms_eval/models/llava.py:351-383`)."""
        segs = self.render(turns + [("gpt", "")])
        # drop the trailing target segment's text (keep role scaffolding)
        text = "".join(s for s, _ in segs[:-1])
        return text


VICUNA_SYSTEM = ("A chat between a curious human and an artificial "
                 "intelligence assistant. The assistant gives helpful, "
                 "detailed, and polite answers to the human's questions.")
VICUNA_SYSTEM_V1 = ("A chat between a curious user and an artificial "
                    "intelligence assistant. The assistant gives helpful, "
                    "detailed, and polite answers to the user's questions.")

CONV_TEMPLATES = {
    "plain": Conversation("plain", "", ("", ""), "plain", sep="\n"),
    "v1": Conversation("v1", VICUNA_SYSTEM_V1, ("USER", "ASSISTANT"),
                       "two", sep=" ", sep2="</s>"),
    "vicuna_v1": Conversation("vicuna_v1", VICUNA_SYSTEM_V1,
                              ("USER", "ASSISTANT"), "two", sep=" ",
                              sep2="</s>"),
    "llama_2": Conversation("llama_2", (
        "You are a helpful language and vision assistant. You are able to "
        "understand the visual content that the user provides, and assist "
        "the user with a variety of tasks using natural language."),
        ("[INST]", "[/INST]"), "llama_2"),
    "mpt": Conversation("mpt", "<|im_start|>system\nA conversation between "
                        "a user and an LLM-based AI assistant. The "
                        "assistant gives helpful and honest answers."
                        "<|im_end|>",
                        ("<|im_start|>user", "<|im_start|>assistant"),
                        "chatml", sep="<|im_end|>"),
    "v0": Conversation("v0", VICUNA_SYSTEM, ("Human", "Assistant"),
                       "single", sep="\n###"),
}


def get_template(name: str) -> Conversation:
    if name not in CONV_TEMPLATES:
        raise ValueError(f"unknown conversation template {name}")
    return CONV_TEMPLATES[name]

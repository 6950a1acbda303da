"""Conversation templates: a copy of flash_vstream_tpu/preprocess/prompts.py,
so the port imports nothing of the JAX package.

Reference: Flash-VStream-LLaVA/flash_vstream/conversation.py (separator styles
SINGLE/TWO/PLAIN/LLAMA_2, templates vicuna_v1/plain/llama_2) and the ChatML
format hand-built in Flash-VStream-Qwen/finetune_flash.py:190-364.
"""
from __future__ import annotations

import dataclasses
from enum import Enum, auto
from typing import List, Optional, Tuple


class SeparatorStyle(Enum):
    SINGLE = auto()
    TWO = auto()
    MPT = auto()
    PLAIN = auto()
    LLAMA_2 = auto()
    CHATML = auto()


@dataclasses.dataclass
class Conversation:
    system: str
    roles: Tuple[str, str]
    messages: List[List]
    sep_style: SeparatorStyle
    sep: str = "###"
    sep2: Optional[str] = None
    version: str = "Unknown"

    def get_prompt(self) -> str:
        messages = self.messages
        if self.sep_style == SeparatorStyle.SINGLE:
            ret = self.system + self.sep
            for role, message in messages:
                if message:
                    ret += role + ": " + message + self.sep
                else:
                    ret += role + ":"
            return ret
        if self.sep_style == SeparatorStyle.TWO:
            seps = [self.sep, self.sep2]
            ret = self.system + seps[0]
            for i, (role, message) in enumerate(messages):
                if message:
                    ret += role + ": " + message + seps[i % 2]
                else:
                    ret += role + ":"
            return ret
        if self.sep_style == SeparatorStyle.MPT:
            # roles carry their own "\n" suffix (conversation.py:63-71)
            ret = self.system + self.sep
            for role, message in messages:
                if message:
                    ret += role + message + self.sep
                else:
                    ret += role
            return ret
        if self.sep_style == SeparatorStyle.PLAIN:
            seps = [self.sep, self.sep2]
            ret = self.system
            for i, (role, message) in enumerate(messages):
                if message:
                    ret += message + seps[i % 2]
            return ret
        if self.sep_style == SeparatorStyle.LLAMA_2:
            def wrap_sys(msg):
                return f"<<SYS>>\n{msg}\n<</SYS>>\n\n" if msg else msg
            def wrap_inst(msg):
                return f"[INST] {msg} [/INST]"
            ret = ""
            for i, (role, message) in enumerate(messages):
                if i == 0:
                    assert message and role == self.roles[0]
                    message = wrap_sys(self.system) + message
                if message:
                    if i % 2 == 0:
                        ret += self.sep + wrap_inst(message)
                    else:
                        ret += " " + message + " " + self.sep2
                else:
                    ret += ""
            return ret.lstrip(self.sep)
        if self.sep_style == SeparatorStyle.CHATML:
            ret = ""
            if self.system:
                ret += f"<|im_start|>system\n{self.system}<|im_end|>\n"
            for role, message in messages:
                if message:
                    ret += f"<|im_start|>{role}\n{message}<|im_end|>\n"
                else:
                    ret += f"<|im_start|>{role}\n"
            return ret
        raise ValueError(f"Invalid style: {self.sep_style}")

    @property
    def stop_str(self) -> str:
        """Generation stop keyword: the assistant-turn terminator
        (model_msvd_qa_featuresloader.py:147-149)."""
        return (self.sep if self.sep_style != SeparatorStyle.TWO
                else self.sep2)

    def append_message(self, role: str, message: Optional[str]):
        self.messages.append([role, message])

    def copy(self) -> "Conversation":
        return Conversation(
            system=self.system, roles=self.roles,
            messages=[[r, m] for r, m in self.messages],
            sep_style=self.sep_style, sep=self.sep, sep2=self.sep2,
            version=self.version)


conv_vicuna_v1 = Conversation(
    system="A chat between a curious user and an artificial intelligence assistant. "
           "The assistant gives helpful, detailed, and polite answers to the user's questions.",
    roles=("USER", "ASSISTANT"),
    messages=[],
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
    version="v1",
)

conv_plain = Conversation(
    system="",
    roles=("", ""),
    messages=[],
    sep_style=SeparatorStyle.PLAIN,
    sep="\n",
    sep2="\n",
    version="plain",
)

conv_llama_2 = Conversation(
    system="You are a helpful language and vision assistant. "
           "You are able to understand the visual content that the user provides, "
           "and assist the user with a variety of tasks using natural language.",
    roles=("USER", "ASSISTANT"),
    messages=[],
    sep_style=SeparatorStyle.LLAMA_2,
    sep="<s>",
    sep2="</s>",
    version="llama_v2",
)

conv_mpt = Conversation(
    system="<|im_start|>system\n"
           "A conversation between a user and an LLM-based AI assistant. "
           "The assistant gives helpful and honest answers.",
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
    messages=[],
    sep_style=SeparatorStyle.MPT,
    sep="<|im_end|>",
    version="mpt",
)

conv_tiny = Conversation(
    system="<|system|>\n"
           "A conversation between a user and an AI assistant. "
           "The assistant gives short and honest answers.",
    roles=("<|user|>\n", "<|assistant|>\n"),
    messages=[],
    sep_style=SeparatorStyle.MPT,
    sep="</s>",
    version="mpt",
)

conv_chatml = Conversation(
    system="You are a helpful assistant.",
    roles=("user", "assistant"),
    messages=[],
    sep_style=SeparatorStyle.CHATML,
    sep="<|im_end|>",
    version="chatml",
)

conv_templates = {
    "v1": conv_vicuna_v1,
    "vicuna_v1": conv_vicuna_v1,
    "plain": conv_plain,
    "llama_2": conv_llama_2,
    "mpt": conv_mpt,
    "tiny": conv_tiny,
    "chatml": conv_chatml,
}
default_conversation = conv_vicuna_v1

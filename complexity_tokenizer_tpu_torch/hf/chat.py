"""Chat templates by pattern, as the reference applies them.

Not a Jinja engine: the template string is searched for the ChatML,
Llama and Alpaca markers and the messages are formatted accordingly, else
as "role: content" lines.
"""

from __future__ import annotations

__all__ = ["apply_chat_template"]


def apply_chat_template(
    template: str,
    messages: list[dict],
    add_generation_prompt: bool,
    bos_token: str,
    eos_token: str,
) -> str:
    result = []
    if "<|im_start|>" in template:
        for msg in messages:
            role = msg.get("role", "user")
            content = msg.get("content", "")
            result.append(f"<|im_start|>{role}\n{content}<|im_end|>\n")
        if add_generation_prompt:
            result.append("<|im_start|>assistant\n")
    elif "[INST]" in template:
        result.append(bos_token)
        for msg in messages:
            role = msg.get("role", "user")
            content = msg.get("content", "")
            if role == "system":
                result.append(f"<<SYS>>\n{content}\n<</SYS>>\n\n")
            elif role == "user":
                result.append(f"[INST] {content} [/INST]")
            elif role == "assistant":
                result.append(f" {content}{eos_token}")
                result.append(bos_token)
    elif "### " in template:
        for msg in messages:
            role = msg.get("role", "user")
            content = msg.get("content", "")
            if role == "system":
                result.append(f"### System:\n{content}\n\n")
            elif role == "user":
                result.append(f"### Human:\n{content}\n\n")
            elif role == "assistant":
                result.append(f"### Assistant:\n{content}\n\n")
        if add_generation_prompt:
            result.append("### Assistant:\n")
    else:
        for msg in messages:
            role = msg.get("role", "user")
            content = msg.get("content", "")
            result.append(f"{role}: {content}\n")
        if add_generation_prompt:
            result.append("assistant: ")
    return "".join(result)

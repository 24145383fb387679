"""The serving example on the PyTorch port (examples/serving-llm/main.py with
gofr_tpu_torch underneath): a Llama generate endpoint behind the
continuous-batching engine, ``POST /generate`` and ``POST /generate/stream``
(server-sent events). The websocket route ``/ws/generate`` waits for an
RFC 6455 layer on the port's stdlib server.

    python examples/serving-llm-torch/main.py            # on the card

    curl -s localhost:8813/generate -d '{"prompt": "hello", "max_new_tokens": 8}'
    curl -sN localhost:8813/generate/stream -d '{"prompt": [1, 2, 3], "max_new_tokens": 8}'

The engine's knobs come from ``configs/.env`` and the environment
(``ENGINE_*``, ``ADAPTER_*``, read as the JAX ``build_engine`` reads them).
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))))

import torch

from gofr_tpu_torch.app import App
from gofr_tpu_torch.config import EnvConfig
from gofr_tpu_torch.models import ModelSpec
from gofr_tpu_torch.models.llama import LlamaConfig


def build_app(config=None, *, preset: str = "tiny", params=None, device=None) -> App:
    """The app, its model ``preset`` ("tiny" in f32, else "one_b" in bf16)
    with ``params`` as its weights (a JAX parameter tree as numpy arrays, or
    None for random weights from seed 0), on ``device`` (the card unless
    given)."""
    folder = _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), "configs")
    app = App(config=config or EnvConfig(folder=folder))

    from gofr_tpu_torch.utils.tokenizer import ByteTokenizer

    # vocab must cover the byte tokenizer's 259 ids; prompts can be raw
    # token-id lists OR strings (encoded through the tokenizer), and results
    # carry decoded text alongside ids. EOS is disabled here because random
    # weights emit any token — a real checkpoint would keep the tokenizer's
    # eos_token_id (build_engine wires it automatically).
    cfg = LlamaConfig.tiny(vocab_size=300) if preset == "tiny" else LlamaConfig.one_b()
    dtype = torch.float32 if preset == "tiny" else torch.bfloat16
    spec = ModelSpec("llama", cfg, task="generate", weights=params, dtype=dtype,
                     tokenizer=ByteTokenizer())
    app.serve_model("lm", spec, slots=4, max_len=64, eos_token_id=-1, device=device)

    async def generate(ctx):
        # async handler + agenerate: awaits the engine future on the event
        # loop instead of parking a handler thread per in-flight request
        body = ctx.bind(dict)
        return await ctx.agenerate(
            "lm", body["prompt"],
            max_new_tokens=int(body.get("max_new_tokens", 8)),
            temperature=float(body.get("temperature", 0.0)),
            timeout=body.get("timeout", 120),
        )

    def generate_stream(ctx):
        """SSE: tokens arrive as `data:` events while decode is running."""
        from gofr_tpu_torch.http.streaming import StreamingResponse

        body = ctx.bind(dict)
        it = ctx.generate(
            "lm", body["prompt"],
            max_new_tokens=int(body.get("max_new_tokens", 8)),
            temperature=float(body.get("temperature", 0.0)),
            timeout=body.get("timeout", 120),
            stream=True,
        )
        return StreamingResponse(it, event="token")

    app.post("/generate", generate)
    app.post("/generate/stream", generate_stream)
    return app


if __name__ == "__main__":
    build_app().run()

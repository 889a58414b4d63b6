"""Write the HF tokenizer directory that the port's tests and
`chip_smoke.py` serve with: tests/fixtures/tokenizer/.

    python scripts/make_tokenizer_fixture.py [--out DIR] [--vocab 4096]

A byte-level BPE trained with the `tokenizers` package on the repo's own
prose (README.md and docs/*.md), in the format the JAX package's
`BPETokenizer.train` writes (specials <|bos|>, <|eos|>, <|pad|>), then
saved by `transformers`' `PreTrainedTokenizerFast.save_pretrained` with
BOS, EOS, PAD and the chat template below. Needs `tokenizers` and
`transformers`; the port reads the result without either.
"""

from __future__ import annotations

import argparse
import glob
import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# A ChatML-style template with the features `apply_chat_template` users
# rely on: bos_token and eos_token, a role check through
# raise_exception, whitespace control and the generation prompt.
CHAT_TEMPLATE = (
    "{{ bos_token }}"
    "{% for message in messages %}"
    "{% if message['role'] not in ['system', 'user', 'assistant', 'tool'] %}"
    "{{ raise_exception('unknown role ' + message['role']) }}"
    "{% endif %}"
    "<|{{ message['role'] }}|>\n{{ message['content'] | trim }}"
    "{{ eos_token }}\n"
    "{% endfor %}"
    "{% if add_generation_prompt %}<|assistant|>\n{% endif %}"
)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(REPO, "tests", "fixtures",
                                                  "tokenizer"))
    ap.add_argument("--vocab", type=int, default=4096)
    args = ap.parse_args()

    from tokenizers import Tokenizer, decoders, models, pre_tokenizers
    from tokenizers.trainers import BpeTrainer
    from transformers import PreTrainedTokenizerFast

    files = [os.path.join(REPO, "README.md")] + sorted(
        glob.glob(os.path.join(REPO, "docs", "*.md")))
    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    trainer = BpeTrainer(
        vocab_size=args.vocab,
        special_tokens=["<|bos|>", "<|eos|>", "<|pad|>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
        show_progress=False,
    )
    tok.train(files, trainer)
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, bos_token="<|bos|>",
                                   eos_token="<|eos|>", pad_token="<|pad|>")
    fast.chat_template = CHAT_TEMPLATE
    os.makedirs(args.out, exist_ok=True)
    fast.save_pretrained(args.out)
    print(args.out, sorted(os.listdir(args.out)), len(fast))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

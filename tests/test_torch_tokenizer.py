"""The port's CLIP BPE tokenizer against the JAX package's, id for id: on the
synthetic HF vocabulary of ``tests/test_tokenizer.py`` and on OpenAI's
single-file layout (``bpe_simple_vocab_16e6.txt``, plain and gzipped), with
punctuation, non-ASCII text and a prompt longer than 77 tokens; and
``default_tokenizer``'s caching rules."""
import gzip
import json

import pytest

from pnpinversion_tpu.utils import tokenizer as jtok
from pnpinversion_tpu_torch.utils import tokenizer as ttok

MERGES = ["c a", "ca t</w>", "d o", "do g</w>", "o n</w>", "a</w>", "t h", "th e</w>",
          "m a", "ma t</w>", "r e", "re d</w>", "' s</w>", "é t", "ét é</w>"]
PROMPTS = [
    "a cat", "a dog on a cat", "dog dog dog", "zz qq", "",
    "A Cat, sitting on THE mat!!  (it's red)",
    "l'été à Paris: café & crème brûlée — 100% ☕ 🐱",
    "&amp; html &lt;escaped&gt; text",
    "  spaced\tout\nlines  ",
    " ".join(["the red cat sat on the mat"] * 14),  # well over 77 tokens
]


def _vocab() -> dict:
    alphabet = list(jtok._bytes_to_unicode().values())
    vocab = {c: i for i, c in enumerate(alphabet)}
    for c in alphabet:
        vocab[c + "</w>"] = len(vocab)
    for m in MERGES:
        vocab.setdefault("".join(m.split()), len(vocab))
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    return vocab


@pytest.fixture(scope="module", params=["hf", "openai", "openai_gz"])
def vocab_dir(request, tmp_path_factory):
    d = tmp_path_factory.mktemp(request.param)
    if request.param == "hf":
        (d / "vocab.json").write_text(json.dumps(_vocab()))
        (d / "merges.txt").write_text("#version: 0.2\n" + "\n".join(MERGES) + "\n")
    else:
        text = "#version: 0.2\n" + "\n".join(MERGES) + "\n"
        if request.param == "openai":
            (d / "bpe_simple_vocab_16e6.txt").write_text(text, encoding="utf-8")
        else:
            with gzip.open(d / "bpe_simple_vocab_16e6.txt.gz", "wt", encoding="utf-8") as f:
                f.write(text)
    return str(d)


@pytest.mark.parametrize("prompt", PROMPTS)
def test_ids_match_jax(vocab_dir, prompt):
    ours, ref = ttok.CLIPBPETokenizer(vocab_dir), jtok.CLIPBPETokenizer(vocab_dir)
    assert (ours.bos_token_id, ours.eos_token_id) == (ref.bos_token_id, ref.eos_token_id)
    assert ours.encode(prompt) == ref.encode(prompt)
    got = ours([prompt, "a cat"], max_length=77)["input_ids"]
    want = ref([prompt, "a cat"], max_length=77)["input_ids"]
    assert got == want and all(len(row) == 77 for row in got)
    assert ours.decode(got[0]) == ref.decode(want[0])


def test_long_prompt_is_truncated_to_an_eos(vocab_dir):
    tok = ttok.CLIPBPETokenizer(vocab_dir)
    ids = tok(PROMPTS[-1], max_length=77)["input_ids"][0]
    assert len(tok.encode(PROMPTS[-1])) > 77
    assert ids[0] == tok.bos_token_id and ids[-1] == tok.eos_token_id


def test_default_tokenizer_caching(vocab_dir, tmp_path):
    """BPE: one instance per directory; otherwise a fresh word tokenizer each
    call (the JAX package's rules)."""
    a, b = ttok.default_tokenizer(vocab_dir), ttok.default_tokenizer(vocab_dir)
    assert isinstance(a, ttok.CLIPBPETokenizer) and a is b
    w1, w2 = ttok.default_tokenizer(str(tmp_path)), ttok.default_tokenizer()
    assert isinstance(w1, ttok.SimpleWordTokenizer) and w1 is not w2
    assert type(jtok.default_tokenizer(str(tmp_path))).__name__ == type(w1).__name__
    with pytest.raises(FileNotFoundError):
        ttok.CLIPBPETokenizer(str(tmp_path))

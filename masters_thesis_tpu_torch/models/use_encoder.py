"""Universal Sentence Encoder (DAN variant) in PyTorch.

The reference embeds captions with TF-Hub
``universal-sentence-encoder/4`` (AttemptFour/get_guse.py:49-63) and scores
caption semantics with it (guse_sim.py:99-131). That model is a Deep
Averaging Network: token (+OOV-hash-bucket) embeddings are sum-pooled with
1/sqrt(n) scaling, then passed through a feed-forward stack to a 512-d
sentence vector.

The port's counterpart of ``masters_thesis_tpu/models/use_encoder.py``, with
the same names, weight bundle and meaning (``tests/test_torch_use_encoder.py``
holds the two together). ``USEDan``'s parameters are named after the flax
tree (``embedding``, ``dan_layer_{i}.kernel`` of shape (in, out),
``dan_layer_{i}.bias``, ``dan_out.kernel``/``bias``), so a bundle's
``/``-joined keys and ``transplant.from_flax`` map onto it unchanged. The JAX
graph has no Pallas kernel (the table lookup is ``jnp.take``, the MLP flax
``Dense``), so eager PyTorch is its port.

Weight bundle format (``.npz``):
  __vocab__        (V,) unicode array — token strings, row i = embedding row i
  __oov_buckets__  ()   int — number of hash buckets appended after the vocab
  __golden_sentences__ (N,) unicode — self-verification probes (optional):
  __golden_vectors__   (N, out) f32   the ORIGINAL model's embeddings of the
                                      probes, captured at conversion time;
                                      ``from_npz`` replays the sentences
                                      through this graph and refuses a bundle
                                      that can't reproduce its own goldens
  embedding        (V + oov, E) float32
  dan_layer_{i}/kernel, dan_layer_{i}/bias      hidden layers (relu)
  dan_out/kernel, dan_out/bias                  final projection to 512

``scripts/convert_tfhub_use.py`` documents how to produce this bundle
offline from the TF-Hub SavedModel; tests exercise the graph with small
synthetic bundles.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch import nn

from masters_thesis_tpu_torch.device import resolve_device
from masters_thesis_tpu_torch.models.common import Dense
from masters_thesis_tpu_torch.transplant import from_flax, to_flax
from masters_thesis_tpu_torch.utils.farmhash import hash_bucket_fast

# sentences a device call embeds: rows are independent, so any chunking
# gives each row the same vector, and 4,096 rows of 64 tokens keep the
# gathered (rows, 64, 512) fp32 block at 0.5 GB where the NSD corpus of
# 365,000 sentences in one call would need ~48 GB for it
EMBED_CHUNK = 4096


def clean_sentence(text: str) -> str:
    """The reference's caption cleaning before embedding
    (get_guse.py:36-42): kill '.'/',', lowercase, collapse whitespace."""
    text = text.replace(".", " ").replace(",", " ")
    return " ".join(w.lower() for w in text.split() if w)


def _oov_bucket(word: str, n_buckets: int) -> int:
    """Hash bucket for out-of-vocabulary tokens — EXACTLY
    ``tf.strings.to_hash_bucket_fast`` (FarmHash Fingerprint64, validated
    against TF golden vectors), so OOV tokens hit the same trained
    embedding rows as the original TF-Hub USE graph."""
    return hash_bucket_fast(word, n_buckets)


class USEDan(nn.Module):
    """DAN sentence encoder: sqrt-n pooled token embeddings -> MLP -> L2
    normalised sentence vector. Initialised as flax initialises it (the
    table from N(0, 1/embed_dim), LeCun-normal kernels, zero biases), from
    ``generator``."""

    def __init__(self, vocab_rows: int, embed_dim: int = 512,
                 hidden: tuple = (512, 512, 512), out_dim: int = 512,
                 generator=None):
        super().__init__()
        self.embedding = nn.Parameter(
            torch.randn(vocab_rows, embed_dim, generator=generator)
            / np.sqrt(embed_dim))
        self.n_hidden = len(hidden)
        width = embed_dim
        for i, out in enumerate(hidden):
            setattr(self, f"dan_layer_{i}",
                    Dense(width, out, generator=generator))
            width = out
        self.dan_out = Dense(width, out_dim, generator=generator)

    def forward(self, token_ids: torch.Tensor,
                lengths: torch.Tensor) -> torch.Tensor:
        """token_ids (B, L) int, 0-padded AFTER real ids; lengths (B,).

        NOTE: row 0 of the table is a real token row, so padding must be
        masked by position (< length), not by id value.
        """
        emb = self.embedding[token_ids]                      # (B, L, E)
        mask = (torch.arange(token_ids.shape[1], device=token_ids.device)
                [None, :] < lengths[:, None]).to(emb.dtype)  # (B, L)
        pooled = (emb * mask[..., None]).sum(dim=1)
        # USE-DAN scales the sum by 1/sqrt(n) (not the mean)
        pooled = pooled / torch.sqrt(
            torch.clamp(lengths.to(emb.dtype), min=1.0))[:, None]
        x = pooled
        for i in range(self.n_hidden):
            x = torch.relu(getattr(self, f"dan_layer_{i}")(x))
        x = self.dan_out(x)
        norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        return x / torch.clamp(norm, min=1e-12)


class USEEncoder:
    """SentenceEmbedder over a weight bundle: tokenizer on the host, the
    DAN on ``device`` (``cuda`` unless the caller passes ``"cpu"``).

    Satisfies evalsuite.guse_sim.SentenceEmbedder; drop-in replacement for
    the offline HashEmbedder once a converted USE bundle is available.
    ``seconds`` adds up the host clock of ``embed``'s two parts:
    ``tokenize`` (cleaning, vocabulary lookups, FarmHash of OOV words) and
    ``device`` (each chunk's upload, forward and copy back).
    """

    name = "use_dan"

    def __init__(self, vocab: list[str], params, oov_buckets: int,
                 hidden: tuple, embed_dim: int, out_dim: int = 512,
                 max_tokens: int = 64, device=None):
        self.vocab = {w: i for i, w in enumerate(vocab)}
        self.n_vocab = len(vocab)
        self.oov_buckets = int(oov_buckets)
        self.dim = out_dim
        self.max_tokens = max_tokens
        self.device = resolve_device(device)
        self.model = USEDan(
            vocab_rows=self.n_vocab + self.oov_buckets,
            embed_dim=embed_dim, hidden=tuple(hidden), out_dim=out_dim,
        )
        self.model.load_state_dict(from_flax({"params": params}))
        # the table goes to the device once, not on every embed call
        self.model.to(self.device).eval()
        self.seconds = {"tokenize": 0.0, "device": 0.0}

    # ---- tokenizer ----
    def token_ids(self, sentence: str) -> list[int]:
        words = clean_sentence(sentence).split()[: self.max_tokens]
        out = []
        for w in words:
            i = self.vocab.get(w)
            if i is None:
                i = self.n_vocab + _oov_bucket(w, self.oov_buckets)
            out.append(i)
        return out

    def tokenize(self, sentences: list[str]) -> tuple[np.ndarray, np.ndarray]:
        """(ids (N, max_tokens) int32 0-padded, lengths (N,) int32). Every
        row is padded to the fixed ``max_tokens`` width (the JAX encoder's
        jitted shape; the mask zeroes the tail either way)."""
        ids = np.zeros((len(sentences), self.max_tokens), np.int32)
        lengths = np.zeros(len(sentences), np.int32)
        for r, s in enumerate(sentences):
            row = self.token_ids(s)
            ids[r, : len(row)] = row
            lengths[r] = len(row)
        return ids, lengths

    @torch.inference_mode()
    def embed(self, sentences: list[str],
              chunk: int = EMBED_CHUNK) -> np.ndarray:
        """(N, dim) vectors, ``chunk`` sentences a device call."""
        if not sentences:
            return np.zeros((0, self.dim), np.float32)
        t0 = time.perf_counter()
        ids, lengths = self.tokenize(sentences)
        t1 = time.perf_counter()
        out = np.empty((len(ids), self.dim), np.float32)
        for i in range(0, len(ids), chunk):
            vecs = self.model(
                torch.from_numpy(ids[i:i + chunk]).to(self.device),
                torch.from_numpy(lengths[i:i + chunk]).to(self.device))
            out[i:i + chunk] = vecs.cpu().numpy()
        self.seconds["tokenize"] += t1 - t0
        self.seconds["device"] += time.perf_counter() - t1
        return out

    # ---- persistence ----
    @classmethod
    def from_npz(cls, path: str, max_tokens: int = 64, verify: bool = True,
                 golden_atol: float = 1e-3, device=None) -> "USEEncoder":
        """Load a weight bundle onto ``device``; when it carries
        conversion-time goldens (``__golden_sentences__``/
        ``__golden_vectors__``), re-embed them and refuse the bundle unless
        this graph reproduces the original model's vectors to
        ``golden_atol`` (both sides are unit-norm, so max-abs is a
        scale-free check). Catches corrupted weights, scrambled embedding
        shards, and graph-topology drift — a wrong GUSE encoder would
        silently mis-score every caption."""
        blob = np.load(path, allow_pickle=False)
        vocab = [str(w) for w in blob["__vocab__"]]
        oov = int(blob["__oov_buckets__"])
        params: dict = {}
        for key in blob.files:
            if key.startswith("__"):
                continue
            node = params
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = blob[key]
        table = params["embedding"]
        hidden = []
        i = 0
        while f"dan_layer_{i}" in params:
            hidden.append(params[f"dan_layer_{i}"]["kernel"].shape[1])
            i += 1
        out_dim = params["dan_out"]["kernel"].shape[1]
        if table.shape[0] != len(vocab) + oov:
            raise ValueError(
                f"USE bundle {path}: embedding rows {table.shape[0]} != "
                f"vocab {len(vocab)} + oov {oov}")
        enc = cls(
            vocab, params, oov, tuple(hidden), table.shape[1], out_dim,
            max_tokens=max_tokens, device=device,
        )
        if verify and "__golden_sentences__" in blob.files:
            sentences = [str(s) for s in blob["__golden_sentences__"]]
            want = np.asarray(blob["__golden_vectors__"], np.float32)
            got = enc.embed(sentences)
            if got.shape != want.shape:
                raise ValueError(
                    f"USE bundle {path}: golden vectors are {want.shape} but "
                    f"this graph emits {got.shape}")
            diff = float(np.max(np.abs(got - want))) if len(sentences) else 0.0
            if diff > golden_atol:
                worst = int(np.argmax(np.max(np.abs(got - want), axis=1)))
                raise ValueError(
                    f"USE bundle {path} failed self-verification: max |Δ| = "
                    f"{diff:.2e} > {golden_atol:.0e} (worst sentence: "
                    f"{sentences[worst]!r}). The bundle's weights do not "
                    f"reproduce the embeddings captured from the original "
                    f"model at conversion time — corrupted file, scrambled "
                    f"shard order, or a graph mismatch. Re-run "
                    f"scripts/convert_tfhub_use.py.")
        return enc


def save_use_bundle(path: str, vocab: list[str], params: dict,
                    oov_buckets: int,
                    goldens: tuple[list[str], np.ndarray] | None = None
                    ) -> None:
    """Write a USEEncoder weight bundle ('/'-joined flax paths + vocab).

    ``goldens``: (sentences, vectors) — the ORIGINAL model's embeddings of
    the sentences, stored for load-time self-verification (from_npz)."""
    flat: dict[str, np.ndarray] = {
        # numpy sizes the unicode width to the longest token — a fixed U64
        # would silently truncate longer tokens, orphaning their trained
        # rows behind OOV lookups after round-trip
        "__vocab__": np.asarray(vocab),
        "__oov_buckets__": np.asarray(oov_buckets),
    }
    if goldens is not None:
        sentences, vectors = goldens
        vectors = np.asarray(vectors, np.float32)
        if len(sentences) != vectors.shape[0]:
            raise ValueError(f"{len(sentences)} golden sentences but "
                             f"{vectors.shape[0]} golden vectors")
        flat["__golden_sentences__"] = np.asarray(sentences)
        flat["__golden_vectors__"] = vectors

    def walk(tree, prefix):
        for k, v in tree.items():
            p = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, p)
            else:
                flat[p] = np.asarray(v)

    walk(params, "")
    np.savez(path, **flat)


def init_use_params(vocab_size: int, oov_buckets: int = 256,
                    embed_dim: int = 128, hidden=(128,), out_dim: int = 512,
                    seed: int = 0) -> dict:
    """Fresh DAN params (fixture bundles / from-scratch training), drawn
    from a ``torch.Generator`` seeded with ``seed``: flax's initialisers in
    distribution, not in value. A nested dict of numpy arrays keyed as the
    flax tree."""
    model = USEDan(
        vocab_rows=vocab_size + oov_buckets, embed_dim=embed_dim,
        hidden=tuple(hidden), out_dim=out_dim,
        generator=torch.Generator().manual_seed(seed),
    )
    return to_flax(model.state_dict())["params"]

"""WordPiece tokenizer: native (C++) fast path + pure-Python reference (the
port's copy of lightningdot_tpu/data/tokenizer.py).

Drop-in for the surface the framework uses from ``transformers.
BertTokenizer`` (the reference tokenizes with that class: queries in
dvl/utils.py:205-208, corpora in uniter_model/prepro.py:25-43): ``encode``,
``tokenize``, ``convert_tokens_to_ids`` and the special-token id
properties.

The cased path (``do_lower_case=False``, what both towers use,
bert-base-cased) runs on ``native/ldtok.cc`` when the native build is
available (:mod:`lightningdot_tpu_torch.native`). The uncased path needs
Unicode case folding and NFD accent stripping; it, and hosts without a
toolchain, use the pure-Python implementation below, which mirrors HF's
BasicTokenizer/WordpieceTokenizer logic.
"""
from __future__ import annotations

import ctypes
import threading
import unicodedata
from typing import Dict, List, Optional

_SPECIALS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")


def _is_whitespace(ch: str) -> bool:
    if ch in " \t\n\r":
        return True
    # U+2028/29 (Zl/Zp): not whitespace to BasicTokenizer._clean_text, but
    # whitespace_tokenize's str.split() splits on them — same effect as
    # mapping to ' ' here (they never compose under NFC). Found by fuzzing.
    if ch in "  ":
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in "\t\n\r":
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96
            or 123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def _clean_and_space(text: str, *, cjk: bool, raw_split_ws: bool = False
                     ) -> str:
    """clean -> (optional CJK spacing) -> NFC, in HF's pipeline order.

    One implementation shared by the pure-Python pipeline (`_basic`) and
    both native-path preps — these must stay byte-identical for
    native/python/HF agreement. ``raw_split_ws`` maps every str.isspace()
    char to ' ' first (raw str.split() word-boundary semantics for the
    per-word prepro protocol: it splits on \\x1c-\\x1f etc. that
    _clean_text would drop).

    HF normalizes to NFC AFTER cleaning/CJK spacing and BEFORE splitting
    ("prevents treating the same character with different unicode
    codepoints as different characters", BasicTokenizer.tokenize) — e.g.
    U+037E GREEK QUESTION MARK becomes ';' (found by fuzzing).
    """
    chars: List[str] = []
    for ch in text:
        if raw_split_ws and ch.isspace():
            chars.append(" ")
            continue
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        if cjk and _is_cjk(cp):
            chars.extend((" ", ch, " "))
        elif _is_whitespace(ch):
            chars.append(" ")
        else:
            chars.append(ch)
    return unicodedata.normalize("NFC", "".join(chars))


class WordPieceTokenizer:
    """BERT tokenizer over an HF-format ``vocab.txt`` (one token per line).

    ``encode(text)`` returns ``[CLS] ids [SEP]`` like the HF class; use
    ``add_special_tokens=False`` for the bare pieces.
    """

    def __init__(self, vocab_file: str, do_lower_case: bool = False,
                 use_native: Optional[bool] = None):
        self.vocab: Dict[str, int] = {}
        with open(vocab_file, encoding="utf-8") as f:
            for i, line in enumerate(f):
                self.vocab[line.rstrip("\r\n")] = i
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        self.do_lower_case = do_lower_case
        self.unk_token_id = self.vocab.get("[UNK]", 0)
        self.cls_token_id = self.vocab.get("[CLS]")
        self.sep_token_id = self.vocab.get("[SEP]")
        self.mask_token_id = self.vocab.get("[MASK]")
        self.pad_token_id = self.vocab.get("[PAD]")

        self._native = None
        self._handle = None
        if use_native is None:
            use_native = not do_lower_case  # native is cased-only
        if use_native and not do_lower_case:
            from lightningdot_tpu_torch.native import load_native

            lib = load_native("ldtok")
            if lib is not None and not hasattr(lib, "ldtok_encode_words"):
                # stale prebuilt .so from before the words API (a host
                # without a toolchain can't rebuild it): degrade to the
                # pure-Python path rather than crash on symbol binding
                lib = None
            if lib is not None:
                lib.ldtok_new.restype = ctypes.c_void_p
                lib.ldtok_new.argtypes = [ctypes.c_char_p]
                lib.ldtok_encode.restype = ctypes.c_int
                lib.ldtok_encode.argtypes = [
                    ctypes.c_void_p, ctypes.c_char_p,
                    ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
                lib.ldtok_encode_words.restype = ctypes.c_int
                lib.ldtok_encode_words.argtypes = [
                    ctypes.c_void_p, ctypes.c_char_p,
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
                lib.ldtok_free.restype = None
                lib.ldtok_free.argtypes = [ctypes.c_void_p]
                handle = lib.ldtok_new(vocab_file.encode())
                if handle:
                    self._native = lib
                    self._handle = handle
                    self._buf = (ctypes.c_int32 * 512)()
                    self._ws_buf = (ctypes.c_uint8 * 512)()
                    # ctypes releases the GIL during the C call, so two
                    # threads could interleave writes into the shared
                    # result buffer (the batching frontend encodes from
                    # its dispatch thread while clients may call directly)
                    self._buf_lock = threading.Lock()

    def __del__(self):
        if getattr(self, "_native", None) is not None and self._handle:
            self._native.ldtok_free(self._handle)
            self._handle = None

    @property
    def native(self) -> bool:
        return self._handle is not None

    # -- HF-compatible surface -------------------------------------------------
    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        if self._handle is not None:
            # errors="ignore" drops lone surrogates — which the reference
            # also drops (category Cs -> control) — instead of raising
            # UnicodeEncodeError.
            raw = self._pre_native(text).encode("utf-8", "ignore")
            with self._buf_lock:
                n = self._native.ldtok_encode(self._handle, raw,
                                              self._buf, len(self._buf))
                if n > len(self._buf):  # rare: grow and re-encode
                    self._buf = (ctypes.c_int32 * (2 * n))()
                    n = self._native.ldtok_encode(self._handle, raw,
                                                  self._buf, len(self._buf))
                ids = list(self._buf[:n])
        else:
            ids = [self.vocab.get(t, self.unk_token_id)
                   for t in self._tokenize_py(text)]
        if add_special_tokens:
            return [self.cls_token_id] + ids + [self.sep_token_id]
        return ids

    def encode_words(self, text: str):
        """(ids, word_starts) — prepro's reconstructable per-word protocol
        (bert_tokenize, uniter_model/prepro.py:25-43) in one call:
        word_starts[i] is True when ids[i] begins a new raw-whitespace
        word (continuation pieces get the IN_WORD prefix downstream)."""
        if self._handle is not None:
            raw = self._prep_words(text).encode("utf-8", "ignore")
            with self._buf_lock:
                n = self._native.ldtok_encode_words(
                    self._handle, raw, self._buf, self._ws_buf,
                    len(self._buf))
                if n > len(self._buf):
                    self._buf = (ctypes.c_int32 * (2 * n))()
                    self._ws_buf = (ctypes.c_uint8 * (2 * n))()
                    n = self._native.ldtok_encode_words(
                        self._handle, raw, self._buf, self._ws_buf,
                        len(self._buf))
                return list(self._buf[:n]), [bool(b)
                                             for b in self._ws_buf[:n]]
        ids: List[int] = []
        starts: List[bool] = []
        for word in text.split():
            for j, p in enumerate(self._tokenize_py(word)):
                ids.append(self.vocab.get(p, self.unk_token_id))
                starts.append(j == 0)
        return ids, starts

    def _prep_words(self, text: str) -> str:
        """Prep for encode_words: clean + NFC, NO CJK spacing (the C side
        inserts CJK separators itself and must distinguish them from real
        whitespace for the word-start flags). NFC-before-CJK is safe: no
        canonical composition pair has a CJK-ideograph base."""
        # word boundaries follow RAW str.split() (bert_tokenize), which
        # also splits on isspace() control chars (\\x1c-\\x1f, \\x0b...)
        # that _clean_text would drop — map them to ' ' up front
        if text.isascii():
            return " ".join(text.replace("\x00", "").split())
        return _clean_and_space(text, cjk=False, raw_split_ws=True)

    def _pre_native(self, text: str) -> str:
        """Host-side prep for the C library, matching HF's pipeline order
        (clean -> CJK spacing -> **NFC**, BasicTokenizer.tokenize).

        The C side has no Unicode normalizer, so for non-ASCII text the
        clean/CJK/NFC stages run here (the C clean/CJK re-run is
        idempotent on the prepped string). ASCII text — the hot serving
        case — is NFC-invariant in every substring and skips the per-char
        pass entirely (NUL stripping only: it would truncate the C string,
        and _clean_text drops it anyway).
        """
        if text.isascii():
            return text.replace("\x00", "")
        return _clean_and_space(text, cjk=True)

    def tokenize(self, text: str) -> List[str]:
        if self._handle is not None:
            return [self.ids_to_tokens[i]
                    for i in self.encode(text, add_special_tokens=False)]
        return self._tokenize_py(text)

    def convert_tokens_to_ids(self, tokens):
        if isinstance(tokens, str):
            return self.vocab.get(tokens, self.unk_token_id)
        return [self.vocab.get(t, self.unk_token_id) for t in tokens]

    def convert_ids_to_tokens(self, ids):
        if isinstance(ids, int):
            return self.ids_to_tokens.get(ids, "[UNK]")
        return [self.ids_to_tokens.get(i, "[UNK]") for i in ids]

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def __len__(self):
        return len(self.vocab)

    # -- pure-Python reference pipeline (mirrors HF BasicTokenizer +
    # WordpieceTokenizer; also the uncased path) -------------------------------
    def _tokenize_py(self, text: str) -> List[str]:
        out: List[str] = []
        for token in self._basic(text):
            if token in _SPECIALS:
                out.append(token)
            else:
                out.extend(self._wordpiece(token))
        return out

    def _basic(self, text: str) -> List[str]:
        tokens: List[str] = []
        for tok in _clean_and_space(text, cjk=True).split(" "):
            if not tok:
                continue
            if tok in _SPECIALS:
                tokens.append(tok)
                continue
            if self.do_lower_case:
                tok = tok.lower()
                # strip accents (HF: NFD, drop Mn)
                tok = "".join(c for c in unicodedata.normalize("NFD", tok)
                              if unicodedata.category(c) != "Mn")
            word: List[str] = []
            for ch in tok:
                if _is_punct(ch):
                    if word:
                        tokens.append("".join(word))
                        word = []
                    tokens.append(ch)
                else:
                    word.append(ch)
            if word:
                tokens.append("".join(word))
        return tokens

    def _wordpiece(self, token: str) -> List[str]:
        if len(token) > 100:  # max_input_chars_per_word
            return ["[UNK]"]
        pieces: List[str] = []
        start = 0
        while start < len(token):
            end = len(token)
            cur = None
            while start < end:
                sub = token[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return ["[UNK]"]
            pieces.append(cur)
            start = end
        return pieces

"""Port parity of the v2 text encoders: ``english_cleaners_v2`` (with its
dates, units, letters-and-numbers and acronym passes), the v3 English number
normaliser, ``CMUDict`` and ``TextProcessor`` with its seeded ``p_arpabet``
mix, against the JAX package's on the same inputs. The comparison is exact:
strings, and ids with their dtype."""
import numpy as np
import pytest

from xva_trainer_tpu.data.text import cleaners_v2 as jcv2
from xva_trainer_tpu.data.text import processor as jproc
from xva_trainer_tpu.data.text.en_numbers_v3 import normalize_numbers as jax_normalize_numbers
from xva_trainer_tpu_torch.data.text import cleaners_v2 as pcv2
from xva_trainer_tpu_torch.data.text import processor as pproc
from xva_trainer_tpu_torch.data.text.en_numbers_v3 import normalize_numbers

TEXTS = [
    "Meet me at 10:30pm, or 7 AM at the latest.",
    "The 4GB card at 2.5GHz beats 512 MB and 3 TB drives; 1 kb, 60hz.",
    "A 1920x1080 screen, a 3 x 4 grid, the 747 and the F16 in the 1920s, 20th.",
    "The NASA and FBI agents met the CEOs; XIV and MIX and DIM and IV.",
    "Mr. Smith paid $4.50 on the 3rd; Dr. Who owes £20 and 1,000,000.",
    "Crème brûlée / naïve // café, jalapeño.",
    "{HH AH0 L OW1} world, the {K AE1 T} sat. NATO {D AO1 G}!",
    "It's 3.14 or 2,500 -- R2D2 and C3PO, 4x4s, the B-52's.",
    "",
    "   spaced    out   text  ",
]


@pytest.mark.parametrize("i", range(len(TEXTS)))
def test_english_cleaners_v2_matches_jax(i):
    t = TEXTS[i]
    assert pcv2.english_cleaners_v2(t) == jcv2.english_cleaners_v2(t)
    for fn in ("expand_datestime", "expand_letters_and_numbers", "spell_acronyms"):
        assert getattr(pcv2, fn)(t) == getattr(jcv2, fn)(t), fn


@pytest.mark.parametrize("i", range(len(TEXTS)))
def test_en_numbers_v3_matches_jax(i):
    assert normalize_numbers(TEXTS[i]) == jax_normalize_numbers(TEXTS[i])


def test_letter_table_matches_jax():
    assert pcv2.LETTER_ARPA == jcv2.LETTER_ARPA


CMU = """;;; a tiny CMUdict in its own format
HELLO  HH AH0 L OW1
WORLD  W ER1 L D
CAT  K AE1 T
CAT(2)  K AA1 T
THE  DH AH0
SAT  S AE1 T
MEET  M IY1 T
AT  AE1 T
## a comment
BROKEN LINE WITH ONE SPACE
"""


@pytest.fixture(scope="module")
def cmudict_path(tmp_path_factory):
    p = tmp_path_factory.mktemp("cmu") / "cmudict-0.7b"
    p.write_text(CMU, encoding="latin-1")
    return str(p)


def test_cmudict_matches_jax(cmudict_path):
    ours, ref = pproc.CMUDict(cmudict_path), jproc.CMUDict(cmudict_path)
    assert ours.entries == ref.entries and len(ours.entries) == 7
    for w in ("hello", "CAT", "missing"):
        assert ours.lookup(w) == ref.lookup(w)
    assert pproc.CMUDict(None).entries == jproc.CMUDict("/absent").entries == {}


@pytest.mark.parametrize("with_dict", [False, True], ids=["no_cmudict", "cmudict"])
@pytest.mark.parametrize("p_arpabet", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("cleaner", ["english_cleaners_v2", "english_cleaners"])
def test_text_processor_matches_jax(cmudict_path, with_dict, p_arpabet, cleaner):
    """One seed: the same draws decide the same words, text after text, so
    the ids agree across the whole sequence of calls."""
    kw = dict(p_arpabet=p_arpabet, cmudict_path=cmudict_path if with_dict else None,
              seed=7, cleaner=cleaner)
    ours, ref = pproc.TextProcessor(**kw), jproc.TextProcessor(**kw)
    assert ours.symbols == ref.symbols and ours.pad_idx == ref.pad_idx
    for t in TEXTS + ["Hello world, the cat sat. Meet at the cat!"] * 3:
        a, b = ours.encode(t), ref.encode(t)
        assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b), t
        assert ours.decode(a) == ref.decode(b)
    assert ours.rng.random() == ref.rng.random()

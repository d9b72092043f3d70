"""The prefill attention's (K2's) plan: which body, how many (query, head)
rows a CTA and which key split each call takes, from its shapes alone
(``repro_torch.kernels.flash_attention.plan``).

Every shape ``chip_smoke.py`` checks (``FLASH_CASES``) and times
(``FLASH_TIMED``) is pinned to the body the card's A/B chose
(``tools/flash_plan.py``: the table "K2's bodies at each timed shape" in
``PERF.md`` section 6); the pooled forwards take
the Hopper body ("wgmma") with 128 rows, so that one CTA walks each (row,
kv head)'s keys once, where G is 1 (at G 4 and 7 the pooled forwards take
64 rows); whisper's encoder runs 128-row CTAs whose two warpgroups take
turns, at least 132 warpgroups and no merge; admissions take 64 rows; a
call with a prefix, or at hd 32 or 80, or with fewer than 128 queries
keeps the mma body; the plan reads shapes only, and the wrapper's one call
of it is built from shape names and the device index. Pure host code: no
kernel runs here (the kernels are held against their plain versions on
the card by ``chip_smoke.check_flash``, through each body).
"""
import ast
import inspect

import pytest

pytest.importorskip("torch")

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

SMS = 132                     # the H100's SMs

# the body, rows a CTA and splits each pinned shape takes on an H100
# (the mma body's splits are its own rule's, ``splits``)
EXPECTED = {
    "pooled": ("wgmma", 128, 1),
    "admission": ("wgmma", 64, 1),
    "tail": ("mma", 64, 1),
    "gqa": ("wgmma", 64, 1),
    "window": ("wgmma", 64, 1),
    "suffix": ("mma", 64, 1),
    "tail_gqa_ragged": ("mma", 64, 1),
    "whisper_encoder": ("wgmma", 128, 1),
    "whisper_encoder_admission": ("wgmma", 128, 1),
    "whisper_cross_prefill": ("mma", 64, 12),
    "whisper_cross_short": ("mma", 64, 12),
    "whisper_decoder_self": ("mma", 64, 1),
    "split_empty_tail": ("mma", 64, 12),
    "split_prefix_boundary": ("mma", 64, 9),
    "split_prefix_crossing": ("mma", 64, 8),
    "hd128": ("mma", 64, 1),
    "hd128_split": ("mma", 64, 3),
    "split_causal_tail": ("mma", 64, 3),
    "split_causal_admission": ("wgmma", 64, 1),
    "moment": ("mma", 64, 1),
    "moment_one": ("mma", 64, 1),
    "qwen2_pooled": ("wgmma", 64, 1),
    "qwen2_admission": ("wgmma", 64, 1),
    "qwen2_tail": ("mma", 64, 1),
    "h2o_pooled": ("mma", 64, 1),
    "h2o_admission": ("mma", 64, 1),
    "h2o_tail": ("mma", 64, 1),
    "h2o_window_prefill": ("mma", 64, 1),
    "olmoe_pooled": ("wgmma", 128, 1),
    "olmoe_admission": ("wgmma", 64, 1),
    "jamba_pooled": ("wgmma", 64, 1),
    "jamba_admission": ("wgmma", 64, 1),
    "grok_pooled": ("mma", 64, 1),
}
# the timed shapes that are no checked case under their own name
TIMED_ONLY = {"tail": ("mma", 64, 1),
              "whisper_encoder": EXPECTED["whisper_encoder_admission"],
              "whisper_cross": EXPECTED["whisper_cross_prefill"]}
CASES = {**cs.FLASH_CASES, **{f"timed_{n}": c
                              for n, c in cs.FLASH_TIMED.items()}}


def shape_of(case: dict) -> tuple:
    """(B, Sq, Sk, Sp, H, KV, hd, causal, window) of a chip_smoke case
    (stablelm-1.6b's heads unless it names its own)."""
    cfg = cs.full_config()
    return (case["B"], case["Sq"], case["Sk"], case.get("Sp", 0),
            case.get("H") or cfg.num_heads, case.get("KV") or cfg.num_kv_heads,
            case.get("hd") or cfg.head_dim, case.get("causal", True),
            case.get("window"))


def test_every_case_is_pinned():
    assert set(EXPECTED) == set(cs.FLASH_CASES)
    assert set(cs.FLASH_TIMED) <= set(cs.FLASH_CASES) | set(TIMED_ONLY)


@pytest.mark.parametrize("name", list(CASES))
def test_plan_at_each_checked_and_timed_shape(name):
    """The body, rows and splits of every checked and timed shape; each
    plan's splits cover the key axis in order, the mma body's from its own
    rule, the Hopper body's in whole key tiles."""
    case = CASES[name]
    short = name.removeprefix("timed_")
    pinned = TIMED_ONLY[short] if name != short and short in TIMED_ONLY \
        else EXPECTED[short]
    shape = shape_of(case)
    p = fa.plan(*shape, SMS)
    assert isinstance(p, fa.Plan)
    body, rows, n, split_len = p
    assert (body, rows, n) == pinned
    keys = shape[2] + shape[3]
    assert n >= 1 and split_len > 0
    assert (n - 1) * split_len < keys <= n * split_len
    if body == "wgmma":
        assert split_len % fa._SM90_TILE == 0 and rows in (64, 128)
        assert shape[6] in fa._SM90_HEAD_DIMS and shape[3] == 0
    else:
        B, Sq, Sk, Sp, H, KV = shape[:6]
        assert (n, split_len) == fa.splits(B, Sq, H, KV, Sp + Sk, SMS)


def test_stablelm_pooled_walks_each_row_and_kv_head_once():
    """128 rows a CTA at the pooled forward (B=32 x 128, H = KV = 32): one
    CTA for each (row, kv head), so its 128 keys are read once."""
    B, Sq, Sk, Sp, H, KV, hd = shape_of(cs.FLASH_CASES["pooled"])[:7]
    body, rows, n, _ = fa.plan(*shape_of(cs.FLASH_CASES["pooled"]), SMS)
    assert (body, rows, n) == ("wgmma", 128, 1)
    assert -(-Sq // (rows // (H // KV))) == 1


@pytest.mark.parametrize("name", ["whisper_encoder_admission",
                                  "whisper_encoder"])
def test_whisper_encoder_fills_the_card(name):
    """Whisper's encoder (1500 frames, 8 heads) keeps every SM's tensor
    cores fed without a merge: 128-row CTAs of two consumer warpgroups that
    take turns on the same tiles, at least 132 warpgroups in all (at one
    row 96 CTAs: faster on the card than 192 one-warpgroup CTAs,
    ``PERF.md``)."""
    shape = shape_of(cs.FLASH_CASES[name])
    B, Sq, Sk, Sp, H, KV = shape[:6]
    body, rows, n, split_len = fa.plan(*shape, SMS)
    assert (body, rows, n) == ("wgmma", 128, 1) and split_len >= Sk
    ctas = -(-Sq // (rows // (H // KV))) * KV * B
    assert ctas * rows // 64 >= SMS


def test_g7_holds_126_live_rows_in_128():
    """qwen2-7b's G 7: 126 live rows (18 queries) at 128 rows a CTA, 63 (9
    queries) at 64, the plan's choice at its pooled forward (faster on the
    card than 128 rows: ``PERF.md``)."""
    shape = shape_of(cs.FLASH_CASES["qwen2_pooled"])
    H, KV = shape[4], shape[5]
    G = H // KV
    assert G == 7 and (128 // G) * G == 126 and (64 // G) * G == 63
    assert fa.plan(*shape, SMS) == fa.Plan("wgmma", 64, 1, 128)


@pytest.mark.parametrize("name", [n for n, c in cs.FLASH_CASES.items()
                                  if c.get("Sp")])
def test_every_prefix_call_keeps_the_mma_body(name):
    assert fa.plan(*shape_of(cs.FLASH_CASES[name]), SMS).body == "mma"


@pytest.mark.parametrize("hd", [32, 80])
def test_head_dims_without_a_hopper_body_keep_the_mma_body(hd):
    assert fa.plan(32, 128, 128, 0, 32, 32, hd, True, None, SMS).body == \
        "mma"


def test_plan_takes_shapes_only():
    """The plan is a function of the shapes and the SM count alone (never
    of kv_len, which lives on the device), so choosing it needs no host
    sync: the wrapper's one call of it is built from shape names and the
    device index only (no length tensor, no read of a tensor's values)."""
    assert list(inspect.signature(fa.plan).parameters) == \
        ["B", "Sq", "Sk", "Sp", "H", "KV", "hd", "causal", "window", "sms"]
    tree = ast.parse(inspect.getsource(fa.flash_attention))
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Name) and n.func.id == "plan"]
    assert len(calls) == 1
    nodes = [n for a in calls[0].args for n in ast.walk(a)]
    names = {n.id for n in nodes if isinstance(n, ast.Name)}
    attrs = {n.attr for n in nodes if isinstance(n, ast.Attribute)}
    assert names <= {"B", "Sq", "Sk", "Sp", "H", "KV", "hd", "causal",
                     "window", "build", "q"}, names
    assert attrs <= {"sm_count", "device", "index"}, attrs


def test_calls_are_counted_by_body():
    """The wrapper counts each call under ``"flash_attention/<body>"``
    beside its launch, with the body the plan chose."""
    src = inspect.getsource(fa.flash_attention)
    assert 'build.LAUNCHES["flash_attention"] += 1' in src
    assert 'build.LAUNCHES[f"flash_attention/{body}"] += 1' in src


@pytest.mark.parametrize("name", list(CASES))
def test_forms_forced_on_the_card_cover_each_body(name):
    """``chip_smoke.flash_forms`` (what ``check_flash`` forces and
    ``tools/flash_plan.py`` times) holds the mma body with its own split,
    the plan's choice where that is the mma body, and the Hopper body at
    64 and 128 rows wherever that body can take the call; its split form's
    splits cover the key axis in order."""
    shape = shape_of(CASES[name])
    B, Sq, Sk, Sp, H, KV, hd = shape[:7]
    forms = cs.flash_forms(shape, SMS)
    assert forms["mma"] == fa.Plan("mma", fa._ROWS,
                                   *fa.splits(B, Sq, H, KV, Sp + Sk, SMS))
    p = fa.plan(*shape, SMS)
    if p.body == "mma":
        assert p == forms["mma"]
    hopper = not Sp and hd in fa._SM90_HEAD_DIMS
    assert {"wgmma64", "wgmma128", "wgmma64_split"} <= set(forms) or \
        not hopper
    assert set(forms) == {"mma"} or hopper
    if hopper:
        n, part = forms["wgmma64_split"][2:]
        assert part % 64 == 0 and (n - 1) * part < Sk <= n * part

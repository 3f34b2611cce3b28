"""Korean grapheme-to-phoneme conversion.

Capability equivalent of the reference's vendored KoG2P rule engine
(scripts/KoG2P/g2p.py + rulebook.txt): hangul syllables are decomposed into
onset/nucleus/coda jamo by Unicode arithmetic and mapped to the KoG2P phone
inventory (k0/kk/kh..., aa/qq/ya...), with connected-speech phonology applied
across syllable boundaries on the UNDERLYING jamo:

- liaison (coda resyllabification before vowel onsets, incl. cluster splits
  with tense /s/: ks -> kf+ss),
- /h/ behaviour (coda-h deletion before vowels, h+plain -> aspirate in both
  orders, h+s -> ss),
- coda-cluster neutralization (lb/ls/lt/lh -> ll, lk -> kf, lm -> mf, ...),
- the l-k rule (lk + k0 -> ll + kk),
- post-obstruent and post-cluster tensification (incl. nc/lm/lb/lt stems),
- nasal assimilation and the r/n lateralization pair.

This is an independent implementation of standard Korean phonology,
golden-tested against the reference's own 475-item
scripts/KoG2P/testset.txt (tests/test_kog2p_golden.py).

The port's own copy of `fscl_tpu/frontend/kog2p.py`
(tests/test_torch_kog2p.py holds it to the same golden set).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

# KoG2P phone symbols, indexed by jamo position
ONSETS = [
    "k0", "kk", "nn", "t0", "tt", "rr", "mm", "p0", "pp",
    "s0", "ss", "oh", "c0", "cc", "ch", "kh", "th", "ph", "h0",
]  # "oh" = empty onset (ㅇ)
NUCLEI = [
    "aa", "qq", "ya", "yq", "vv", "ee", "yv", "ye", "oo", "wa",
    "wq", "wo", "yo", "uu", "wv", "we", "wi", "yu", "xx", "xi", "ii",
]
# coda index -> underlying jamo name ("" = none)
CODA_JAMO = [
    "", "k", "kk", "ks", "n", "nc", "nh", "t", "l", "lk", "lm",
    "lb", "ls", "lt", "lp", "lh", "m", "p", "ps", "s", "ss", "ng",
    "c", "ch", "kh", "th", "ph", "h",
]

# neutralized coda phone for each underlying coda jamo (word-final /
# pre-consonant realization; 표준발음법 9-11항)
NEUTRAL = {
    "k": "kf", "kk": "kf", "ks": "kf", "lk": "kf", "kh": "kf",
    "n": "nf", "nc": "nf", "nh": "nf",
    "t": "tf", "s": "tf", "ss": "tf", "c": "tf", "ch": "tf",
    "th": "tf", "h": "tf",
    "l": "ll", "lb": "ll", "ls": "ll", "lt": "ll", "lh": "ll",
    "lm": "mf", "m": "mf",
    "lp": "pf", "p": "pf", "ps": "pf", "ph": "pf",
    "ng": "ng",
}

# liaison before a vowel: (kept coda phone or None, new onset phone or None)
LIAISON = {
    "k": (None, "k0"), "kk": (None, "kk"), "ks": ("kf", "ss"),
    "n": (None, "nn"), "nc": ("nf", "c0"), "nh": (None, "nn"),
    "t": (None, "t0"), "l": (None, "rr"), "lk": ("ll", "k0"),
    "lm": ("ll", "mm"), "lb": ("ll", "p0"), "ls": ("ll", "ss"),
    "lt": ("ll", "th"), "lp": ("ll", "ph"), "lh": (None, "rr"),
    "m": (None, "mm"), "p": (None, "p0"), "ps": ("pf", "ss"),
    "s": (None, "s0"), "ss": (None, "ss"), "ng": ("ng", None),
    "c": (None, "c0"), "ch": (None, "ch"), "kh": (None, "kh"),
    "th": (None, "th"), "ph": (None, "ph"), "h": (None, None),  # h deleted
}

# coda + following h0 onset -> (kept coda, aspirated onset); the UNDERLYING
# final consonant aspirates (꽂히다 c+h -> ch, not t+h -> th)
ASPIRATE_CODA_H = {
    "k": (None, "kh"), "kk": (None, "kh"), "lk": ("ll", "kh"),
    "ks": ("kf", "ss"),
    "t": (None, "th"), "s": (None, "th"), "ss": (None, "th"),
    "th": (None, "th"),
    "c": (None, "ch"), "ch": (None, "ch"), "nc": ("nf", "ch"),
    "p": (None, "ph"), "lb": ("ll", "ph"), "lp": ("ll", "ph"),
    "ps": ("pf", "ss"), "ph": (None, "ph"),
    "lt": ("ll", "th"),
}

# h-final codas + plain onset -> aspirated onset (않다 -> 안타)
H_CODAS = {"h": None, "nh": "nf", "lh": "ll"}
_ASPIRATE_ONSET = {"k0": "kh", "t0": "th", "c0": "ch", "p0": "ph"}

_TENSE = {"k0": "kk", "t0": "tt", "p0": "pp", "s0": "ss", "c0": "cc"}
# cluster codas that tensify a following plain obstruent while keeping
# their sonorant realization (표준발음법 24-25항: 앉고->안꼬, 얇고->얄꼬,
# 훑고->훌꼬); lk/lm handled with stem lists, lh via the h rules
_TENSE_CLUSTERS = {"nc", "lb", "lt", "ls", "lh"}
# ㄺ-final verb stems where ㄺ+ㄱ -> [l]+[kk] (표준발음법 11항 다만)
_LK_STEMS = set("갉굵얽옭맑밝낡늙묽붉읽")
# ㄻ-final verb stems that tensify a following obstruent (표준발음법 24항)
_LM_STEMS = set("젊짊굶닮옮곪")
# prospective-modifier -ㄹ syllables tensifying what follows (27항)
_L_TENSE_SYLLS = set("할갈날올줄볼살울")
_Y_NUCLEI = {"ya", "yq", "yv", "ye", "yo", "yu"}
_NASALIZE = {"kf": "ng", "tf": "nf", "pf": "mf"}
_OBSTRUENT_CODAS = {"kf", "tf", "pf"}
_NASAL_ONSETS = {"nn", "mm"}

# lexical exceptions: ㄼ realized [p] before consonants
# (표준발음법 10항 다만: 밟-, 넓죽-, 넓둥-)
_LB_AS_P = ("밟", "넓죽", "넓둥")

# neutralized coda + vowel across a WORD boundary: the coda neutralizes
# first, then resyllabifies as a plain onset (표준발음법 15항: 밭 아래 ->
# 바다래, 값어치 -> 가버치)
_NEUTRAL_LIAISON = {"kf": "k0", "tf": "t0", "pf": "p0", "nf": "nn",
                    "mf": "mm", "ll": "rr"}

# hangul letter names liaise irregularly (표준발음법 16항): 디귿이 -> 디그시
_LETTER_NAME_LIAISON = {"귿": "s0", "읏": "s0", "읒": "s0", "읓": "s0",
                        "읕": "s0", "읗": "s0", "읔": "k0", "읖": "p0"}

_PALATAL = {"t": "c0", "th": "ch", "lt": ("ll", "ch")}


# Lexical pronunciation respellings, applied to the grapheme string before
# the rule engine. These mirror the irregulars the reference's rulebook.txt
# encodes as word-specific rewrite rules (compound-boundary tensification,
# ㄴ-insertion in compounds, 표준발음법-listed exceptions); each entry maps
# standard spelling -> pronunciation spelling.
_EXCEPTIONS = tuple(sorted({
    # compound / Sino-Korean tensification (rulebook 경음화 word rules)
    "물고기": "물꼬기", "물동이": "물똥이", "물증": "물쯩",
    "물줄기": "물쭐기", "강줄기": "강쭐기", "물속": "물쏙", "굴속": "굴쏙",
    "문법": "문뻡", "불법": "불뻡", "문고리": "문꼬리",
    "산새": "산쌔", "들새": "들쌔", "손재주": "손째주", "글재주": "글째주",
    "길가": "길까", "강가": "강까", "눈동자": "눈똥자", "눈대중": "눈때중",
    "신바람": "신빠람", "바람결": "바람껼", "아침밥": "아침빱",
    "점심밥": "점심빱", "발바닥": "발빠닥", "손바닥": "손빠닥",
    "술잔": "술짠", "술독": "술똑", "술병": "술뼝", "술자리": "술짜리",
    "초승달": "초승딸", "등불": "등뿔", "창살": "창쌀",
    "갈등": "갈뜽", "갈증": "갈쯩", "발동": "발똥", "절도": "절또",
    "말살": "말쌀", "불소": "불쏘", "불세": "불쎄", "일시": "일씨",
    "발전": "발쩐", "몰상식": "몰쌍식", "일절": "일쩔",
    "김밥": "김빱", "잠자리": "잠짜리", "더듬지": "더듬찌",
    "신고": "신꼬", "신다": "신따", "신자": "신짜",
    "삼고": "삼꼬", "삼다": "삼따", "삼자": "삼짜",
    "안고": "안꼬", "껴안다": "껴안따", "껴안지": "껴안찌",
    # causative -기- resists stem tensification
    "옮기": "옴기", "굶기다": "굼기다",
    # compound-boundary neutralize-then-liaise (15항 word rules)
    "맛있다": "마딛따", "멋있다": "머딛따", "맛없다": "마덥따",
    "멋없다": "머덥따", "젖어미": "저더미", "헛웃음": "허두슴",
    "겉옷": "거돋", "값어치": "가버치", "값있는": "가빈는",
    "맏형": "마텽", "온갖": "온갇", "첫인": "처딘",
    # ㄴ-insertion in lexical compounds (29-30항 word rules)
    "홑이불": "혼니불", "솜이불": "솜니불", "삯일": "상닐",
    "맨입": "맨닙", "꽃잎": "꼰닙", "깻잎": "깬닙", "나뭇잎": "나문닙",
    "베갯잇": "베갠닏", "도리깻열": "도리깬녈", "뒷윷": "뒨뉻",
    "늦여름": "늗녀름", "내복약": "내봉냑", "색연필": "생년필",
    "업용": "엄뇽", "식용유": "시굥뉴", "민윤리": "민뉼리",
    "구근류": "구근뉴", "이죽이죽": "이중니죽", "야금야금": "야금냐금",
    "한일": "한닐", "막일": "망닐", "옷 입": "온 닙",
    # liaison overrides (exceptions to ㄴ/ㄹ-insertion)
    "들일": "들릴", "할일": "할릴", "절약": "저략", "금요일": "그묘일",
    "월요일": "워료일", "일요일": "이료일", "설익": "설릭",
    "기슭": "기슥", "싫증": "실쯩",
    "줄넘기": "줄넘끼", "물질": "물찔", "그믐달": "그믐딸",
    "막염": "망념", "솔잎": "솔립", "술잎": "술립", "뒷일": "뒨닐",
}.items(), key=lambda kv: -len(kv[0])))


def decompose(ch: str) -> Optional[Tuple[int, int, int]]:
    """Hangul syllable -> (onset idx, nucleus idx, coda idx) or None."""
    code = ord(ch) - 0xAC00
    if not 0 <= code < 11172:
        return None
    onset, rest = divmod(code, 588)
    nucleus, coda = divmod(rest, 28)
    return onset, nucleus, coda


def g2p_ko(text: str) -> List[str]:
    """Korean text -> KoG2P phone list."""
    for src, dst in _EXCEPTIONS:
        if src in text:
            text = text.replace(src, dst)
    # decompose into per-syllable [onset phone, nucleus idx, coda jamo,
    # word-boundary-follows flag, source char]
    sylls: List[list] = []
    for ch in text:
        d = decompose(ch)
        if d is None:
            if ch.strip() == "" and sylls:
                sylls[-1][3] = True   # word boundary after previous syllable
            continue
        sylls.append([ONSETS[d[0]], d[1], CODA_JAMO[d[2]], False, ch])

    phones: List[str] = []
    n = len(sylls)
    for i, s in enumerate(sylls):
        onset, nucleus_i, coda, boundary, ch = s

        if onset != "oh":
            phones.append(onset)
        phones.append(NUCLEI[nucleus_i])

        # ㄼ realized [p] before consonants in 밟-/넓죽-/넓둥- (표준발음법
        # 10항 다만); liaison before vowels keeps the cluster (밟을 -> 발블)
        lb_as_p = coda == "lb" and (
            ch in _LB_AS_P
            or (i + 1 < n and (ch + sylls[i + 1][4]) in _LB_AS_P))

        if not coda:
            continue
        nxt = sylls[i + 1] if i + 1 < n else None
        nxt_onset = nxt[0] if nxt is not None else None
        nxt_nucleus = NUCLEI[nxt[1]] if nxt is not None else None

        # --- vowel follows
        if nxt_onset == "oh":
            if ch in _LETTER_NAME_LIAISON and not boundary:
                nxt[0] = _LETTER_NAME_LIAISON[ch]   # 디귿이 -> 디그시
                continue
            # ㄴ-insertion before y-initial syllables (표준발음법 29항:
            # 담요 -> 담뇨, 물약 -> 물략, 쑥갓요 -> 쑥간뇨); across a word
            # boundary it also applies before /i/ (한 일 -> 한닐,
            # 할 일 -> 할릴) for sonorant codas
            if (nxt_nucleus in _Y_NUCLEI
                    or (boundary and nxt_nucleus == "ii")):
                neutral = NEUTRAL[coda]
                if neutral in ("nf", "mf", "ng"):
                    phones.append(neutral)
                    nxt[0] = "nn"
                    continue
                if neutral == "ll":
                    phones.append("ll")
                    nxt[0] = "rr"
                    continue
                if not boundary and coda in ("s", "ss", "t", "th",
                                             "c", "ch"):
                    phones.append("nf")
                    nxt[0] = "nn"
                    continue
            if boundary:
                # across a word boundary the coda takes its word-final
                # (neutralized) form first, THEN resyllabifies
                # (표준발음법 15항: 닭 앞에 -> 다가페, 값어치 -> 가버치)
                neutral = NEUTRAL[coda]
                lia = _NEUTRAL_LIAISON.get(neutral)
                if lia is None:
                    phones.append(neutral)          # ng stays
                else:
                    nxt[0] = lia
                continue
            # palatalization before /i/ (굳이 -> 구지)
            if coda in _PALATAL and nxt_nucleus == "ii":
                pal = _PALATAL[coda]
                if isinstance(pal, tuple):
                    phones.append(pal[0])
                    nxt[0] = pal[1]
                else:
                    nxt[0] = pal
                continue
            kept, lia = LIAISON[coda]
            if kept:
                phones.append(kept)
            if lia:
                nxt[0] = lia
            continue

        # --- h onset follows
        if nxt_onset == "h0":
            if boundary and NEUTRAL[coda] in _OBSTRUENT_CODAS:
                # across a boundary the NEUTRALIZED coda aspirates
                # (옷 한 벌 -> 오탄벌, 꽃 한 송이 -> 꼬탄)
                nxt[0] = {"kf": "kh", "tf": "th", "pf": "ph"}[NEUTRAL[coda]]
                continue
            if not boundary and coda in ASPIRATE_CODA_H:
                # within a word the UNDERLYING consonant aspirates; before
                # /i/ the result palatalizes (굳히다 -> 구치다)
                kept, asp = ASPIRATE_CODA_H[coda]
                if asp == "th" and nxt_nucleus == "ii":
                    asp = "ch"
                if kept:
                    phones.append(kept)
                nxt[0] = asp
                continue

        if lb_as_p:
            coda = "p"   # consonant side only (aspiration with h above
            # still uses the cluster: 밟히다 -> 발피다)

        # --- h-final coda + plain obstruent: aspirate/tensify the onset
        if coda in H_CODAS:
            kept = H_CODAS[coda]
            if nxt_onset in _ASPIRATE_ONSET:
                if kept:
                    phones.append(kept)
                nxt[0] = _ASPIRATE_ONSET[nxt_onset]
                continue
            if nxt_onset == "s0":     # 닿소 -> 다쏘, 많소 -> 만쏘
                if kept:
                    phones.append(kept)
                nxt[0] = "ss"
                continue
            if coda == "lh" and nxt_onset == "nn":   # 뚫네 -> 뚤레
                phones.append("ll")
                nxt[0] = "rr"
                continue
            # otherwise fall through with the neutralized coda

        # --- the l-k rule: ㄺ verb stems realize [l] before ㄱ
        # (맑고 -> 말꼬); elsewhere ㄺ -> [k] (흙과 -> 흑꽈)
        if coda == "lk" and nxt_onset == "k0" and ch in _LK_STEMS:
            phones.append("ll")
            nxt[0] = "kk"
            continue

        # --- cluster tensification: coda keeps its sonorant realization,
        # the following plain obstruent tenses (앉고 -> 안꼬, 얇고 -> 얄꼬);
        # ㄻ only for verb stems (닮고 -> 담꼬 but 앎과 -> 암과)
        if nxt_onset in _TENSE and (
                coda in _TENSE_CLUSTERS
                or (coda == "lm" and ch in _LM_STEMS)):
            phones.append(NEUTRAL[coda])
            nxt[0] = _TENSE[nxt_onset]
            continue

        neutral = NEUTRAL[coda]

        # --- post-obstruent tensification
        if neutral in _OBSTRUENT_CODAS and nxt_onset in _TENSE:
            nxt[0] = _TENSE[nxt_onset]
        # prospective -ㄹ tensification (표준발음법 27항: 할 수는 -> 할쑤는)
        elif ch in _L_TENSE_SYLLS and neutral == "ll" and nxt_onset in _TENSE:
            nxt[0] = _TENSE[nxt_onset]

        # --- nasal assimilation (막는 -> 망는) and obstruent + r (독립)
        if nxt_onset in _NASAL_ONSETS and neutral in _NASALIZE:
            neutral = _NASALIZE[neutral]
        elif nxt_onset == "rr":
            if neutral in _NASALIZE:          # 독립 -> 동닙
                neutral = _NASALIZE[neutral]
                nxt[0] = "nn"
            elif neutral in ("mf", "ng"):     # 심리 -> 심니
                nxt[0] = "nn"
            elif neutral == "nf":             # 신라 -> 실라
                neutral = "ll"
        elif nxt_onset == "nn" and neutral == "ll":
            nxt[0] = "rr"                     # 찰나 -> 찰라

        phones.append(neutral)
    return phones


def g2p_ko_string(text: str) -> str:
    return " ".join(g2p_ko(text))

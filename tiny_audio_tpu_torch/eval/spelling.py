"""British->American spelling map (the equivalent of Whisper's ``english.json``).

The port's copy of :mod:`tiny_audio_tpu.eval.spelling`: an offline map built
from curated stem families, every entry a known-safe British->American pair
(the families expanded to their inflected forms, as that file is
structured).  A real ``english.json`` named by ``TA_ENGLISH_JSON`` (or passed
as ``spelling_path`` to :class:`~tiny_audio_tpu_torch.eval.normalizer.TextNormalizer`)
takes precedence wholesale.
"""

from __future__ import annotations

import json
import os
from functools import lru_cache
from pathlib import Path

# -ise/-isation verbs (expand: ise ises ised ising isation isations iser isers)
_ISE_STEMS = [
    "accessor", "apolog", "author", "bapt", "capital", "categor", "central",
    "character", "civil", "colon", "commercial", "critic", "crystall",
    "custom", "democrat", "demoral", "digit", "dramat", "emphas", "energ",
    "equal", "familiar", "fantas", "fertil", "final", "formal", "fossil",
    "general", "harmon", "hospital", "hypnot", "ideal", "immun",
    "individual", "industrial", "international", "item", "jeopard", "legal",
    "liberal", "local", "magnet", "marginal", "material", "maxim", "memor",
    "minim", "mobil", "modern", "monopol", "moral", "national", "natural",
    "neutral", "normal", "optim", "organ", "patron", "penal", "personal",
    "philosoph", "plagiar", "polar", "popular", "prior", "privat", "public",
    "pulver", "rational", "real", "recogn", "revolution", "romantic",
    "scandal", "scrutin", "sensational", "social", "special", "stabil",
    "standard", "steril", "stigmat", "subsid", "summar", "symbol",
    "sympath", "synchron", "synthes", "terror", "theor", "tranquill",
    "traumat", "trivial", "union", "urban", "util", "vandal", "vapor",
    "verbal", "visual", "vocal", "vulgar", "western",
]
# -yse verbs (expand: yse yses ysed ysing)
_YSE_STEMS = ["anal", "catal", "paral", "psychoanal", "breathal", "dial", "hydrol"]
# -our nouns (expand: our ours oured ouring where sensible)
_OUR_STEMS = [
    "arbo", "ardo", "armo", "behavio", "cando", "clamo", "colo", "demeano",
    "endeavo", "favo", "fervo", "flavo", "glamo", "harbo", "hono", "humo",
    "labo", "neighbo", "odo", "parlo", "ranco", "rigo", "rumo", "savo",
    "splendo", "succo", "tumo", "valo", "vapo", "vigo",
]
_OUR_VERBY = {"arm", "behavi", "col", "endeav", "fav", "flav", "harb", "hon",
              "lab", "neighb", "rum", "sav"}  # stems that take -oured/-ouring
# -re nouns (expand: re res)
_RE_WORDS = [
    "calibre", "centre", "fibre", "goitre", "litre", "lustre", "manoeuvre",
    "meagre", "metre", "mitre", "nitre", "ochre", "reconnoitre", "sabre",
    "saltpetre", "sceptre", "sepulchre", "sombre", "spectre", "theatre",
    "louvre", "accoutre", "amphitheatre", "centimetre", "kilometre",
    "millimetre", "epicentre", "mediocre",  # mediocre identical both sides
]
_RE_SKIP = {"mediocre", "massacre", "acre", "ogre"}  # same in both variants
# doubled-l inflections (expand: led ling ler lers)
_LL_STEMS = [
    "cancel", "channel", "chisel", "counsel", "dial", "duel", "equal",
    "fuel", "funnel", "gambol", "grovel", "label", "level", "libel",
    "marshal", "marvel", "model", "panel", "pedal", "quarrel", "ravel",
    "revel", "rival", "shovel", "shrivel", "signal", "snorkel", "spiral",
    "squirrel", "swivel", "tassel", "total", "towel", "travel", "tunnel",
    "unravel", "yodel",
]
# ae/oe digraphs (exact pairs)
_DIGRAPH = {
    "aeon": "eon", "aeons": "eons", "anaemia": "anemia", "anaemic": "anemic",
    "anaesthesia": "anesthesia", "anaesthetic": "anesthetic",
    "anaesthetics": "anesthetics", "anaesthetist": "anesthetist",
    "caesium": "cesium", "coeliac": "celiac", "diarrhoea": "diarrhea",
    "encyclopaedia": "encyclopedia", "encyclopaedias": "encyclopedias",
    "faeces": "feces", "foetal": "fetal", "foetus": "fetus",
    "gynaecology": "gynecology", "haematology": "hematology",
    "haemoglobin": "hemoglobin", "haemophilia": "hemophilia",
    "haemorrhage": "hemorrhage", "haemorrhoids": "hemorrhoids",
    "leukaemia": "leukemia", "mediaeval": "medieval",
    "oedema": "edema", "oesophagus": "esophagus", "oestrogen": "estrogen",
    "orthopaedic": "orthopedic", "paediatric": "pediatric",
    "paediatrician": "pediatrician", "paedophile": "pedophile",
    "palaeontology": "paleontology", "septicaemia": "septicemia",
}
# miscellaneous exact pairs
_MISC = {
    "aeroplane": "airplane", "aeroplanes": "airplanes",
    "aluminium": "aluminum", "artefact": "artifact", "artefacts": "artifacts",
    "cheque": "check", "chequebook": "checkbook", "cheques": "checks",
    "chequered": "checkered", "chilli": "chili", "cosy": "cozy",
    "defence": "defense", "defences": "defenses", "dependant": "dependent",
    "dependants": "dependents", "disc": "disk", "discs": "disks",
    "distil": "distill", "doughnut": "donut", "doughnuts": "donuts",
    "draught": "draft", "draughts": "drafts", "draughty": "drafty",
    "enrol": "enroll", "enrolment": "enrollment", "enthral": "enthrall",
    "fulfil": "fulfill", "fulfilment": "fulfillment", "gaol": "jail",
    "grey": "gray", "greyed": "grayed", "greying": "graying",
    "greyish": "grayish", "greys": "grays", "instalment": "installment",
    "instalments": "installments", "instil": "instill",
    "jewellery": "jewelry", "judgement": "judgment",
    "judgements": "judgments", "kerb": "curb", "kerbs": "curbs",
    "licence": "license", "licences": "licenses", "manoeuvre": "maneuver",
    "manoeuvres": "maneuvers", "mould": "mold", "moulded": "molded",
    "moulding": "molding", "moulds": "molds", "moult": "molt",
    "moustache": "mustache", "moustaches": "mustaches",
    "offence": "offense", "offences": "offenses", "omelette": "omelet",
    "omelettes": "omelets", "plough": "plow", "ploughed": "plowed",
    "ploughing": "plowing", "ploughs": "plows", "practise": "practice",
    "practised": "practiced", "practises": "practices",
    "practising": "practicing", "pretence": "pretense",
    "pretences": "pretenses", "programme": "program",
    "programmes": "programs", "pyjamas": "pajamas", "sceptic": "skeptic",
    "sceptical": "skeptical", "scepticism": "skepticism",
    "sceptics": "skeptics", "skilful": "skillful", "skilfully": "skillfully",
    "smoulder": "smolder", "smouldering": "smoldering",
    "speciality": "specialty", "specialities": "specialties",
    "storey": "story", "storeys": "stories", "sulphur": "sulfur",
    "titbit": "tidbit", "titbits": "tidbits", "tranquillity": "tranquility",
    "tyre": "tire", "tyres": "tires", "wilful": "willful",
    "wilfully": "willfully", "woollen": "woolen",
    "catalogue": "catalog", "catalogued": "cataloged",
    "catalogues": "catalogs", "dialogue": "dialog", "dialogues": "dialogs",
    "epilogue": "epilog", "monologue": "monolog", "prologue": "prolog",
}


def _build_default_map() -> dict[str, str]:
    m: dict[str, str] = {}
    for stem in _ISE_STEMS:
        for suf_br, suf_us in [
            ("ise", "ize"), ("ises", "izes"), ("ised", "ized"),
            ("ising", "izing"), ("isation", "ization"),
            ("isations", "izations"), ("iser", "izer"), ("isers", "izers"),
        ]:
            m[stem + suf_br] = stem + suf_us
    for stem in _YSE_STEMS:
        for suf_br, suf_us in [
            ("yse", "yze"), ("yses", "yzes"), ("ysed", "yzed"),
            ("ysing", "yzing"),
        ]:
            m[stem + suf_br] = stem + suf_us
    for stem in _OUR_STEMS:
        base = stem[:-1]  # strip the trailing 'o' of the stem spelling
        m[base + "our"] = base + "or"
        m[base + "ours"] = base + "ors"
        if base in _OUR_VERBY:
            m[base + "oured"] = base + "ored"
            m[base + "ouring"] = base + "oring"
    for extra_br, extra_us in [
        ("favourite", "favorite"), ("favourites", "favorites"),
        ("favouritism", "favoritism"), ("colourful", "colorful"),
        ("colourless", "colorless"), ("honourable", "honorable"),
        ("humourless", "humorless"), ("labourer", "laborer"),
        ("labourers", "laborers"), ("neighbourhood", "neighborhood"),
        ("neighbourhoods", "neighborhoods"), ("neighbouring", "neighboring"),
        ("behavioural", "behavioral"), ("glamourous", "glamorous"),
    ]:
        m[extra_br] = extra_us
    for word in _RE_WORDS:
        if word in _RE_SKIP:
            continue
        us = word[:-2] + "er"
        m[word] = us
        m[word + "s"] = us + "s"
    for stem in _LL_STEMS:
        for suf_br, suf_us in [
            ("led", "ed"), ("ling", "ing"), ("ler", "er"), ("lers", "ers"),
        ]:
            m[stem + suf_br] = stem + suf_us  # travelled -> traveled etc.
    m.update(_DIGRAPH)
    m.update(_MISC)
    # identity-safe: never map a word to itself
    return {k: v for k, v in m.items() if k != v}


@lru_cache(maxsize=4)
def load_spelling_map(path: str | None = None) -> dict[str, str]:
    """The British->American map: an ``english.json`` file when provided
    (argument or ``TA_ENGLISH_JSON`` env var), else the built-in map."""
    path = path or os.environ.get("TA_ENGLISH_JSON")
    if path and Path(path).is_file():
        return json.loads(Path(path).read_text())
    return _build_default_map()

"""Compact synonym table for METEOR's synonym stage.

The port's own copy of ``text_to_sound_synthesis_tpu/evaluation/synonyms.py``
(the same groups, the same resolution order).

The reference's METEOR (coco-caption Java jar driven from
``Codebook/AudiocaptionLoss/eval_metrics.py:243-249``) matches WordNet
synonyms in its third alignment stage. Where no WordNet corpus is
installed, ``caption_metrics._wordnet_synsets`` falls back to this module,
which vendors a CURATED
compact table of synonym groups — hand-assembled for the audio-captioning
domain (AudioCaps / AudioSet caption vocabulary), following WordNet 3.0's
lemma groupings in spirit but written from scratch (it is a fixture, not a
corpus copy) — so the synonym stage has a real, tested execution path.

Resolution order used by the METEOR scorer:
  1. a real nltk WordNet corpus, when one is installed (full coverage);
  2. a user table via ``T2S_SYNONYMS=/path/to/groups.txt`` (one group per
     line, whitespace-separated lowercase lemmas);
  3. this vendored table.

Tokens are matched after Porter stemming fails, exactly as in the reference
pipeline, so groups list base forms; morphology is the stemmer's job.
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import Dict, FrozenSet, Optional, Sequence, Tuple

__all__ = ["SYNONYM_GROUPS", "load_synonym_table", "synonym_lookup"]

# One tuple per synonym group (symmetric: every member is a synonym of every
# other member). Domain-curated for sound-event captions.
SYNONYM_GROUPS: Tuple[Tuple[str, ...], ...] = (
    # animals & their calls
    ("dog", "canine", "hound"),
    ("puppy", "pup"),
    ("bark", "yap", "woof", "bowwow"),
    ("howl", "wail", "yowl"),
    ("cat", "feline", "kitty"),
    ("meow", "miaow", "mew"),
    ("bird", "fowl"),
    ("chirp", "tweet", "twitter", "chirrup"),
    ("crow", "caw"),
    ("rooster", "cock", "cockerel"),
    ("cow", "bovine"),
    ("moo", "low"),
    ("sheep", "ewe"),
    ("bleat", "baa"),
    ("pig", "hog", "swine"),
    ("oink", "grunt"),
    ("horse", "steed", "equine"),
    ("neigh", "whinny", "nicker"),
    ("goat", "billy"),
    ("frog", "toad"),
    ("croak", "ribbit"),
    ("insect", "bug"),
    ("buzz", "hum", "drone"),
    ("snake", "serpent"),
    ("hiss", "sizzle", "fizzle"),
    # people & vocal sounds
    ("man", "male", "gentleman", "guy"),
    ("woman", "female", "lady"),
    ("child", "kid", "youngster"),
    ("baby", "infant"),
    ("person", "human", "individual"),
    ("crowd", "throng", "mob"),
    ("speak", "talk"),
    ("say", "state", "tell"),
    ("speech", "address"),
    ("shout", "yell", "holler", "scream", "cry"),
    ("laugh", "giggle", "chuckle"),
    ("weep", "sob"),
    ("whisper", "murmur", "mutter"),
    ("sing", "vocalize"),
    ("song", "tune", "melody"),
    ("cough", "hack"),
    ("sneeze", "achoo"),
    ("snore", "snort"),
    ("breathe", "respire"),
    ("clap", "applaud"),
    ("applause", "clapping", "ovation"),
    ("whistle", "whistling"),
    ("footstep", "footfall", "step"),
    ("walk", "stroll", "amble"),
    ("run", "sprint", "jog"),
    # weather & nature
    ("rain", "rainfall", "shower"),
    ("drizzle", "sprinkle"),
    ("storm", "tempest"),
    ("thunder", "thunderclap"),
    ("wind", "breeze", "gust"),
    ("blow", "gust"),
    ("wave", "breaker", "surf"),
    ("ocean", "sea"),
    ("stream", "brook", "creek"),
    ("river", "waterway"),
    ("water", "aqua"),
    ("drip", "trickle", "dribble"),
    ("splash", "splatter", "spatter"),
    ("pour", "gush"),
    ("flow", "stream", "run"),
    ("fire", "flame", "blaze"),
    ("crackle", "crepitate"),
    ("leaf", "foliage"),
    ("tree", "timber"),
    ("forest", "wood", "woods"),
    # vehicles & machines
    ("car", "auto", "automobile", "motorcar"),
    ("truck", "lorry"),
    ("motorcycle", "motorbike", "bike"),
    ("bus", "coach"),
    ("train", "railway", "locomotive"),
    ("airplane", "aeroplane", "plane", "aircraft"),
    ("helicopter", "chopper", "copter"),
    ("boat", "vessel", "ship"),
    ("engine", "motor"),
    ("rev", "race"),
    ("horn", "hooter", "klaxon"),
    ("honk", "beep", "toot", "hoot"),
    ("siren", "alarm"),
    ("brake", "braking"),
    ("accelerate", "speed"),
    ("drive", "motor"),
    ("machine", "device", "apparatus"),
    ("drill", "bore"),
    ("saw", "sawing"),
    ("hammer", "pound"),
    ("vacuum", "hoover"),
    ("fan", "blower"),
    ("clock", "timepiece"),
    ("tick", "ticktock"),
    ("bell", "chime", "toll"),
    ("ring", "peal", "chime"),
    ("phone", "telephone"),
    ("gun", "firearm", "weapon"),
    ("gunshot", "shot", "gunfire"),
    ("fireworks", "firecracker"),
    ("explosion", "blast", "detonation"),
    ("explode", "detonate", "burst"),
    # household & objects
    ("door", "doorway"),
    ("slam", "bang"),
    ("knock", "rap", "tap"),
    ("creak", "squeak", "screech"),
    ("window", "pane"),
    ("shatter", "smash", "break"),
    ("glass", "glassware"),
    ("dish", "plate"),
    ("cutlery", "silverware"),
    ("paper", "sheet"),
    ("rustle", "swish", "whoosh"),
    ("crumple", "crinkle", "scrunch"),
    ("tear", "rip"),
    ("scrape", "scratch", "grate"),
    ("thud", "thump", "clunk"),
    ("clatter", "rattle", "clank", "clang"),
    ("crash", "smash", "collide"),
    ("music", "tune"),
    ("drum", "percussion"),
    ("guitar", "axe"),
    ("piano", "keyboard"),
    ("roof", "rooftop", "housetop"),
    ("house", "home", "dwelling"),
    ("road", "street", "roadway"),
    # qualities & misc verbs
    ("loud", "noisy"),
    ("quiet", "silent", "still", "soft"),
    ("fast", "quick", "rapid", "speedy"),
    ("slow", "sluggish"),
    ("big", "large", "huge"),
    ("small", "little", "tiny"),
    ("begin", "start", "commence"),
    ("end", "finish", "stop", "cease"),
    ("continue", "persist", "proceed"),
    ("repeat", "echo"),
    ("distant", "faraway", "remote"),
    ("near", "close", "nearby"),
    ("rumble", "grumble", "growl"),
    ("roar", "bellow", "boom"),
    ("squeal", "shriek", "screech"),
    ("whine", "whimper"),
    ("click", "clack"),
    ("pop", "crack", "snap"),
    ("noise", "sound", "racket", "din"),
)


def _table_from_groups(groups: Sequence[Sequence[str]]) -> Dict[str, FrozenSet[str]]:
    acc: Dict[str, set] = {}
    for group in groups:
        members = {w.lower() for w in group}
        for w in members:
            acc.setdefault(w, set()).update(members)
    # a word is trivially its own synonym (WordNet lemma sets include the word)
    return {w: frozenset(s | {w}) for w, s in acc.items()}


def load_synonym_table(path: Optional[str] = None) -> Dict[str, FrozenSet[str]]:
    """word -> frozenset(synonyms incl. itself). ``path`` (or $T2S_SYNONYMS)
    points at a text file of one whitespace-separated group per line;
    ``#``-comments and blank lines ignored. Default: the vendored groups."""
    path = path or os.environ.get("T2S_SYNONYMS")
    if path:
        groups = []
        with open(path) as f:
            for line in f:
                line = line.split("#", 1)[0].strip()
                if line:
                    groups.append(line.split())
        return _table_from_groups(groups)
    return _table_from_groups(SYNONYM_GROUPS)


@lru_cache(maxsize=2)
def _cached_table(path: Optional[str]) -> Dict[str, FrozenSet[str]]:
    return load_synonym_table(path)


def synonym_lookup(word: str) -> FrozenSet[str]:
    """Synonyms of ``word`` from the active table (empty set if unknown)."""
    table = _cached_table(os.environ.get("T2S_SYNONYMS"))
    return table.get(word.lower(), frozenset())

"""Prompt-topic pool.

Reference: ``experiment/topics.csv`` — 100 popular-encyclopedia-page subjects,
one drawn uniformly per run (experiment/RunnerConfig.py:115-118). This is an
original general-knowledge list with the same role and size; topic choice
only varies the prompt bytes, the run table records which one was used.
"""

from __future__ import annotations

import random
from typing import List, Optional

TOPICS: List[str] = [
    "the water cycle", "photosynthesis", "plate tectonics", "the solar system",
    "black holes", "the speed of light", "electricity", "magnetism",
    "the periodic table", "chemical bonds", "DNA replication", "evolution",
    "the immune system", "the human brain", "vaccines", "antibiotics",
    "climate change", "renewable energy", "nuclear fission", "semiconductors",
    "the internet", "machine learning", "cryptography", "quantum computing",
    "the printing press", "the industrial revolution", "the silk road",
    "ancient rome", "ancient egypt", "the renaissance", "the enlightenment",
    "the french revolution", "the space race", "the cold war",
    "the united nations", "world trade", "supply and demand", "inflation",
    "central banks", "stock markets", "game theory", "probability",
    "prime numbers", "calculus", "geometry", "statistics", "logic",
    "linguistics", "the origin of writing", "the history of mathematics",
    "volcanoes", "earthquakes", "hurricanes", "ocean currents", "glaciers",
    "coral reefs", "rainforests", "deserts", "migration of birds",
    "honeybees", "whales", "dinosaurs", "fossils", "the carbon cycle",
    "soil formation", "agriculture", "irrigation", "fermentation",
    "the history of medicine", "anatomy", "genetics", "proteins",
    "photography", "cinema", "classical music", "jazz", "the violin",
    "oil painting", "sculpture", "architecture", "bridges", "skyscrapers",
    "railways", "aviation", "submarines", "satellites", "telescopes",
    "microscopes", "clocks and timekeeping", "calendars", "maps",
    "navigation", "olympic games", "chess", "football", "marathon running",
    "tea", "coffee", "chocolate", "bread", "cheese",
]


def pick_topic(seed: Optional[int] = None) -> str:
    """Uniform draw; seedable so a run's topic is reproducible from its id."""
    rng = random.Random(seed)
    return rng.choice(TOPICS)

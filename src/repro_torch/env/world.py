"""Synthetic GeoLLM-Engine world: imagery catalog, knowledge base, web,
audio clips — all seeded/deterministic, all queryable through the tool
implementations in env/tools_impl.py.

The world carries *ground truth* (object counts, land-cover fractions,
article contents) so the evaluator can score detection F1, LCC R and
Rouge-L against reality rather than against the agent's own outputs.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

SENSORS = ("xview1", "sentinel2", "landsat8", "naip", "worldview3")
CITIES = ("Tampa Bay, FL", "Seattle, WA", "Rotterdam", "Singapore",
          "Cape Town", "Mumbai", "Osaka", "Hamburg", "Valparaiso",
          "Anchorage, AK", "Doha", "Gdansk")
OBJECT_CLASSES = ("airplane", "ship", "storage tank", "vehicle", "helipad",
                  "bridge", "crane")
LANDCOVER_CLASSES = ("water", "trees", "crops", "built", "bare", "grass")


@dataclass
class ImageRecord:
    image_id: str
    sensor: str
    region: str
    date: str            # ISO yyyy-mm-dd
    cloud: float
    objects: Dict[str, int]
    landcover: Dict[str, float]
    caption: str


@dataclass
class World:
    images: Dict[str, ImageRecord]
    regions: Dict[str, Tuple[float, float, float, float]]
    wiki: Dict[str, str]
    web: Dict[str, Dict[str, str]]        # url -> {title, text}
    audio: Dict[str, str]                 # clip id -> transcript
    seed: int

    def catalog_rows(self) -> List[ImageRecord]:
        return list(self.images.values())

    def fingerprint(self) -> str:
        """Stable digest of all shared world state.

        The tool-graph compiler's cross-session fusion is only sound
        because the World is READ-ONLY at execution time — every mutable
        resource lives in the per-session Workspace (the hazard alphabet
        in env/tools_impl.TOOL_EFFECTS). Parity tests snapshot this
        before/after fused runs to hold the executors to that contract.
        """
        import hashlib
        h = hashlib.sha256()
        for iid in sorted(self.images):
            r = self.images[iid]
            h.update(repr((r.image_id, r.sensor, r.region, r.date,
                           r.cloud, sorted(r.objects.items()),
                           sorted(r.landcover.items()),
                           r.caption)).encode())
        for part in (sorted(self.regions.items()), sorted(self.wiki.items()),
                     sorted((u, sorted(p.items()))
                            for u, p in self.web.items()),
                     sorted(self.audio.items()), self.seed):
            h.update(repr(part).encode())
        return h.hexdigest()


def _date(rng) -> str:
    y = int(rng.integers(2019, 2024))
    m = int(rng.integers(1, 13))
    d = int(rng.integers(1, 28))
    return f"{y:04d}-{m:02d}-{d:02d}"


def build_world(seed: int = 0, n_images: int = 600) -> World:
    rng = np.random.default_rng(seed)
    regions = {c: tuple(np.round(rng.uniform(-60, 60, 4), 3)) for c in CITIES}
    images: Dict[str, ImageRecord] = {}
    for i in range(n_images):
        sensor = SENSORS[int(rng.integers(0, len(SENSORS)))]
        region = CITIES[int(rng.integers(0, len(CITIES)))]
        objects = {c: int(rng.poisson(3.0)) for c in OBJECT_CLASSES
                   if rng.random() < 0.5}
        lc_raw = rng.dirichlet(np.ones(len(LANDCOVER_CLASSES)))
        landcover = {c: float(np.round(f, 4))
                     for c, f in zip(LANDCOVER_CLASSES, lc_raw)}
        main_obj = max(objects, key=objects.get) if objects else "terrain"
        caption = (f"{sensor} scene over {region} showing {main_obj} "
                   f"near the waterfront")
        images[f"img_{i:05d}"] = ImageRecord(
            image_id=f"img_{i:05d}", sensor=sensor, region=region,
            date=_date(rng), cloud=float(np.round(rng.uniform(0, 0.9), 3)),
            objects=objects, landcover=landcover, caption=caption)

    wiki = {}
    topics = ["object detection models", "NDVI", "synthetic aperture radar",
              "land cover classification", "cloud masking",
              "image georeferencing", "xview dataset", "sentinel-2 bands",
              "prompting techniques", "system-efficient LLM serving",
              "airplane detection", "ship detection", "change detection",
              "tool-augmented agents", "remote sensing benchmarks"]
    for t in topics:
        body = (f"{t.capitalize()}: reference article. "
                + " ".join(f"fact_{t.replace(' ', '_')}_{j}"
                           for j in range(40)))
        wiki[t] = body

    web = {}
    for j in range(40):
        url = f"https://example.org/page{j}"
        web[url] = {"title": f"Result {j}",
                    "text": f"web page {j} content " + " ".join(
                        f"w{j}_{k}" for k in range(60))}

    audio = {f"clip_{j:03d}":
             f"meeting recording {j} about satellite tasking and "
             f"acquisition windows item {j}" for j in range(20)}

    return World(images=images, regions=regions, wiki=wiki, web=web,
                 audio=audio, seed=seed)

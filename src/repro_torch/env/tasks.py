"""Task generator: GeoLLM-Engine-style benchmark tasks with ground-truth
plans (the "-5k"/"-10k" benchmark of the paper is a seeded draw of these).

Each task carries:
  * the natural-language query,
  * its intent (hidden from the agent at runtime — the gate must infer it),
  * the ground-truth plan: a list of *stages*; calls inside one stage are
    what an ideal multi-tool planner can aggregate into one LLM step,
  * checker metadata for the evaluator.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.env.world import (CITIES, OBJECT_CLASSES, LANDCOVER_CLASSES,
                             SENSORS, World)


@dataclass(frozen=True)
class ToolCall:
    tool: str
    args: Dict[str, Any] = field(default_factory=dict)


@dataclass
class Task:
    task_id: str
    query: str
    intent: str
    plan: List[List[ToolCall]]          # stages of aggregatable calls
    checker: Dict[str, Any]             # evaluator metadata
    metric_family: str                  # none|detection|landcover|vqa


def _img_filter_args(rng, world: World):
    sensor = SENSORS[int(rng.integers(0, len(SENSORS)))]
    city = CITIES[int(rng.integers(0, len(CITIES)))]
    rows = [r for r in world.catalog_rows()
            if r.sensor == sensor and r.region == city]
    max_cloud = 0.4
    return sensor, city, max_cloud, [r.image_id for r in rows][:24]


def gen_task(world: World, rng: np.random.Generator, idx: int) -> Task:
    kind = idx % 8
    tid = f"task_{idx:05d}"

    if kind == 0:   # load→filter→plot
        sensor, city, mc, ids = _img_filter_args(rng, world)
        query = (f"Plot {sensor} images around {city} with cloud cover "
                 f"below {int(mc*100)}% on the map")
        plan = [
            [ToolCall("sql_query_regions", {"place": city}),
             ToolCall("sql_query_images", {"sensor": sensor, "region": city,
                                           "max_cloud": mc})],
            [ToolCall("load_images", {"image_ids": ids or
                                      ["img_00000"]}),
             ToolCall("filter_clouds", {"max_cloud": mc})],
            [ToolCall("reproject", {"crs": "EPSG:4326"}),
             ToolCall("mosaic", {})],
            [ToolCall("plot_map", {"region": city}),
             ToolCall("add_layer", {"layer": "basemap-labels"})],
            [ToolCall("screenshot_map", {})],
        ]
        return Task(tid, query, "load_filter_plot", plan,
                    {"expect_map": True,
                     "expect_handles": [i for i in (ids or ["img_00000"])
                                        if world.images[i].cloud <= mc]},
                    "none")

    if kind == 1:   # detection / counting
        sensor, city, mc, ids = _img_filter_args(rng, world)
        cls = OBJECT_CLASSES[int(rng.integers(0, len(OBJECT_CLASSES)))]
        ids = ids or ["img_00001"]
        query = (f"How many {cls}s are visible in {sensor} imagery "
                 f"of {city}? Draw the detections on the map.")
        plan = [
            [ToolCall("sql_query_regions", {"place": city}),
             ToolCall("sql_query_images", {"sensor": sensor,
                                           "region": city})],
            [ToolCall("suggest_model", {"task": f"{cls} detection"}),
             ToolCall("load_images", {"image_ids": ids})],
            [ToolCall("detect_objects", {"classes": [cls]}),
             ToolCall("count_objects", {"classes": [cls]})],
            [ToolCall("draw_bboxes", {"detections": [cls]}),
             ToolCall("screenshot_map", {})],
        ]
        gt = sum(world.images[i].objects.get(cls, 0) for i in ids)
        return Task(tid, query, "detection_analysis", plan,
                    {"class": cls, "handles": ids, "gt_count": gt,
                     "expect_map": True}, "detection")

    if kind == 2:   # landcover
        sensor, city, mc, ids = _img_filter_args(rng, world)
        ids = ids or ["img_00002"]
        # the plan cloud-filters at 0.5; ground truth mirrors that subset
        ids_kept = [i for i in ids if world.images[i].cloud <= 0.5]
        ids_for_gt = ids_kept or ids
        query = (f"What is the dominant land cover class around {city} "
                 f"according to {sensor} data?")
        plan = [
            [ToolCall("sql_query_regions", {"place": city}),
             ToolCall("sql_query_images", {"sensor": sensor,
                                           "region": city})],
            [ToolCall("load_images", {"image_ids": ids}),
             ToolCall("filter_clouds", {"max_cloud": 0.5})],
            [ToolCall("classify_landcover", {})],
            [ToolCall("landcover_stats", {}),
             ToolCall("plot_histogram", {"source": "landcover"})],
        ]
        agg = {c: float(np.mean([world.images[i].landcover[c]
                                 for i in ids_for_gt]))
               for c in LANDCOVER_CLASSES}
        return Task(tid, query, "landcover_analysis", plan,
                    {"handles": ids_for_gt, "gt_fractions": agg,
                     "gt_dominant": max(agg, key=agg.get)}, "landcover")

    if kind == 3:   # information seeking
        topic = sorted(world.wiki)[int(rng.integers(0, len(world.wiki)))]
        query = f"Look up and summarize what we know about {topic}."
        plan = [
            [ToolCall("wiki_search", {"query": topic})],
            [ToolCall("wiki_get", {"title": topic})],
            [ToolCall("wiki_summarize", {"title": topic})],
        ]
        return Task(tid, query, "information_seeking", plan,
                    {"gt_text": world.wiki[topic]}, "vqa")

    if kind == 4:   # ui/web navigation
        query = ("Search the web for 'system-efficient LLM prompting' and "
                 "open the most relevant result")
        url = sorted(world.web)[0]
        plan = [
            [ToolCall("web_search", {"query":
                                     "system-efficient LLM prompting"})],
            [ToolCall("open_url", {"url": url}),
             ToolCall("ui_scroll", {"direction": "down"})],
            [ToolCall("ui_read", {"label": "main-content"}),
             ToolCall("ui_open_panel", {"panel": "notes"})],
        ]
        return Task(tid, query, "ui_web_navigation", plan,
                    {"expect_page": url}, "none")

    if kind == 5:   # visual QA
        ids = sorted(world.images)
        h = ids[int(rng.integers(0, len(ids)))]
        query = f"Describe what is shown in catalog image {h}."
        plan = [
            [ToolCall("sql_sample", {"filter": f"id='{h}'", "n": 1}),
             ToolCall("load_images", {"image_ids": [h]})],
            [ToolCall("visual_qa", {"handle": h,
                                    "question": "describe the scene"})],
            [ToolCall("caption_image", {"handle": h})],
        ]
        return Task(tid, query, "visual_qa", plan,
                    {"handle": h, "gt_text": world.images[h].caption},
                    "vqa")

    if kind == 6:   # speech transcription
        clip = sorted(world.audio)[int(rng.integers(0, len(world.audio)))]
        query = f"Transcribe audio clip {clip} and summarize it."
        plan = [
            [ToolCall("transcribe_audio", {"clip": clip})],
            [ToolCall("wiki_search", {"query": "satellite tasking"})],
        ]
        return Task(tid, query, "speech_transcription", plan,
                    {"gt_text": world.audio[clip]}, "vqa")

    # kind == 7: code / tabulation
    sensor, city, mc, ids = _img_filter_args(rng, world)
    query = (f"Tabulate the number of catalog images per sensor for "
             f"{city}.")
    plan = [
        [ToolCall("sql_distinct", {"column": "sensor"}),
         ToolCall("sql_count", {"filter": f"region='{city}'"})],
        [ToolCall("tabulate", {"records": []})],
    ]
    return Task(tid, query, "code_analysis", plan,
                {"expect_artifact": "tabulate"}, "none")


def make_benchmark(world: World, n_tasks: int, seed: int = 0) -> List[Task]:
    rng = np.random.default_rng(seed + 17)
    return [gen_task(world, rng, i) for i in range(n_tasks)]

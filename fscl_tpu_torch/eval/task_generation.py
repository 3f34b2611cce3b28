"""Few-shot task generation with phoneme coverage (port of
`fscl_tpu/eval/task_generation.py`; the same `random.Random(seed)` draws, so
the same tasks).

Re-provides scripts/few_shot_task_generation.py:24-156: build K-shot tasks
whose support set phoneme-covers the query set; extend 4->8->16->... shot
tasks sharing ONE query set; write `<N>-shot/task-<i>/{train,val}.txt` +
`config.yaml` data-config bundles compatible with `read_data_config`.
"""
from __future__ import annotations

import os
import random
from typing import Dict, List, Sequence, Set, Tuple

import yaml

from fscl_tpu_torch.data.feature_store import (
    FeatureStore, read_queries_from_txt, write_queries_to_txt,
)


def collect_phonemes(store: FeatureStore, queries) -> Set[str]:
    phns: Set[str] = set()
    for q in queries:
        phns.update(store.phoneme.read_from_query(q).split())
    return phns


class TaskGenerator:
    def __init__(self, dataset_name: str, store: FeatureStore, lang_id,
                 symbol_id: str, max_trial: int = 1000, seed: int = 666):
        self.store = store
        self.dataset_name = dataset_name
        self.lang_id = lang_id
        self.symbol_id = symbol_id
        self.max_trial = max_trial
        self.rng = random.Random(seed)

    def _base_sup_candidates(self, queries, n_sup: int, n_candidates: int):
        """Random support candidates sorted by phoneme coverage (desc)."""
        res = []
        for _ in range(n_candidates):
            cand = self.rng.sample(queries, n_sup)
            res.append((collect_phonemes(self.store, cand), cand))
        res.sort(key=lambda x: len(x[0]), reverse=True)
        return res

    def generate_base_tasks(self, queries, n_sup: int, n_qry: int,
                            n_tasks: int, n_candidates: int = 4000):
        res = []
        for phns, sup in self._base_sup_candidates(queries, n_sup,
                                                   n_candidates):
            sup_names = {q["basename"] for q in sup}
            pool = [q for q in queries if q["basename"] not in sup_names]
            fail, qry = 0, []
            while fail < self.max_trial and len(qry) < n_qry and pool:
                idx = self.rng.randint(0, len(pool) - 1)
                q = pool.pop(idx)
                if phns >= collect_phonemes(self.store, [q]):
                    qry.append(q)
                else:
                    fail += 1
            if len(qry) == n_qry:
                res.append((sup, qry))
            if len(res) == n_tasks:
                return res
        raise ValueError("Failed to generate coverage-satisfying tasks")

    def generate_extend_tasks(self, queries, shots: Sequence[int], base_task):
        sup, qry = base_task
        assert min(shots) == len(sup)
        names = {q["basename"] for q in sup + qry}
        pool = [q for q in queries if q["basename"] not in names]
        res = [base_task]
        for n in sorted(shots)[1:]:
            sup_ext = self.rng.sample(pool, n - len(sup))
            res.append((sup + sup_ext, qry))
        return res

    def config_template(self) -> Dict:
        return {
            "dataset": self.dataset_name,
            "name": self.dataset_name,
            "lang_id": self.lang_id,
            "symbol_id": self.symbol_id,
            "data_dir": self.store.root,
            "subsets": {"train": "train.txt", "val": "val.txt",
                        "test": "val.txt"},
        }

    def generate(self, src_txt_path: str, output_dir: str,
                 shots: Sequence[int], n_qry: int = 64, n_tasks: int = 20):
        os.makedirs(output_dir, exist_ok=True)
        queries = read_queries_from_txt(src_txt_path)
        base_tasks = self.generate_base_tasks(queries, min(shots), n_qry,
                                              n_tasks)
        for i, base in enumerate(base_tasks):
            for n_sup, (sup, qry) in zip(sorted(shots),
                                         self.generate_extend_tasks(
                                             queries, shots, base)):
                dst = os.path.join(output_dir, f"{n_sup}-shot", f"task-{i}")
                os.makedirs(dst, exist_ok=True)
                write_queries_to_txt(self.store, sup,
                                     os.path.join(dst, "train.txt"))
                write_queries_to_txt(self.store, qry,
                                     os.path.join(dst, "val.txt"))
                with open(os.path.join(dst, "config.yaml"), "w") as f:
                    yaml.safe_dump(self.config_template(), f,
                                   sort_keys=False)


def collect_phoneme_set(stores: List[FeatureStore], output_path: str):
    """Build MFA/<Lang>/phoneset.txt from preprocessed corpora
    (scripts/collect_phonemes.py:8-50)."""
    phns: Set[str] = set()
    for store in stores:
        for q in store.load_metadata():
            if store.phoneme.exists(q):
                phns.update(store.phoneme.read_from_query(q).split())
    phns -= {"sp", "spn", "sil"}
    os.makedirs(os.path.dirname(os.path.abspath(output_path)), exist_ok=True)
    with open(output_path, "w", encoding="utf-8") as f:
        f.write("\n".join(sorted(phns)) + "\n")
    return sorted(phns)

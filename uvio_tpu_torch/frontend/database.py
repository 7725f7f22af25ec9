"""Host-side feature track store (a copy of `uvio_tpu/frontend/database.py`).

Equivalent of `ov_core/src/feat/FeatureDatabase.{h,cpp}` + `Feature.h`:
id -> per-camera list of stamped uv observations, with the temporal
queries the manager's triage needs. This bookkeeping is deliberately
host-side; the device consumes padded track tensors built from it.

The temporal queries are indexed by timestamp (`_by_time`): the naive
feature x observation scan in `features_seen_at` showed up as a
per-frame host hotspot in live-loop profiling (each frame queries the
marginalized clone time over every track's full history).
"""

from __future__ import annotations

from typing import Dict, List, Set, Tuple


def _tkey(t: float) -> int:
    """Quantize a stamp to integer nanoseconds for index keys: callers
    that recompute a stamp (rather than passing it verbatim) still hit
    the same bucket, matching the pre-index scan's 1e-9 tolerance."""
    return int(round(t * 1e9))


class Feature:
    __slots__ = ("feat_id", "obs", "to_delete", "_n", "_newest")

    def __init__(self, feat_id: int):
        self.feat_id = feat_id
        # cam_id -> list[(t, u, v)] (time-ordered)
        self.obs: Dict[int, List[Tuple[float, float, float]]] = {}
        self.to_delete = False
        # cached aggregates (num_obs/newest_time are called ~1000x per
        # frame by triage sorting; recomputing them scanned every obs)
        self._n = 0
        self._newest = -1.0

    def add(self, t: float, cam: int, u: float, v: float):
        self.obs.setdefault(cam, []).append((t, u, v))
        self._n += 1
        if t > self._newest:
            self._newest = t

    def times(self):
        ts = set()
        for lst in self.obs.values():
            ts.update(t for t, _, _ in lst)
        return ts

    def newest_time(self):
        return self._newest

    def oldest_time(self):
        return min((lst[0][0] for lst in self.obs.values() if lst), default=-1.0)

    def num_obs(self):
        return self._n

    def clean_older_than(self, t: float):
        """Remove measurements at times < t (clean_old_measurements)."""
        if self.oldest_time() >= t:
            return  # nothing to trim (common case)
        n = 0
        for c in list(self.obs.keys()):
            self.obs[c] = [o for o in self.obs[c] if o[0] >= t]
            if not self.obs[c]:
                del self.obs[c]
            else:
                n += len(self.obs[c])
        self._n = n
        if n == 0:
            self._newest = -1.0


class FeatureDatabase:
    def __init__(self):
        self.features: Dict[int, Feature] = {}
        # ns-quantized timestamp -> feature ids observed at that stamp
        self._by_time: Dict[int, Set[int]] = {}

    def update_feature(self, feat_id: int, t: float, cam: int, u: float, v: float):
        f = self.features.get(feat_id)
        if f is None:
            f = Feature(feat_id)
            self.features[feat_id] = f
        f.add(t, cam, u, v)
        self._by_time.setdefault(_tkey(t), set()).add(feat_id)

    def features_not_seen_at(self, t: float):
        """Lost tracks: newest obs strictly older than t
        (features_not_containing_newer semantics)."""
        return [f for f in self.features.values() if f.newest_time() < t]

    def features_seen_at(self, t: float):
        """Tracks with an observation at exactly time t
        (features_containing semantics)."""
        tk = _tkey(t)
        ids = self._by_time.get(tk)
        if ids is None:
            return []
        # Validate each hit against the feature's actual observations:
        # ids are REUSED across feature generations (sim ids are map
        # indices), so an index entry can point at a re-created feature
        # that never saw this frame.
        live = set()
        for i in ids:
            f = self.features.get(i)
            if f is not None and any(
                _tkey(o[0]) == tk for lst in f.obs.values() for o in lst
            ):
                live.add(i)
        if len(live) != len(ids):
            self._by_time[tk] = live
        # emit in feature-INSERTION order (dict order of self.features):
        # downstream triage breaks num_obs ties by this order, and the
        # pre-index full scan iterated insertion order — iteration order
        # is behavior here, not cosmetics (changing it to sorted-by-id
        # shifted which tied candidates became SLAM landmarks and
        # measurably regressed the mono_slam/stereo_slam head-to-heads)
        return [f for f in self.features.values() if f.feat_id in live]

    def cleanup(self):
        self.features = {
            i: f for i, f in self.features.items() if not f.to_delete and f.num_obs() > 0
        }

    def cleanup_older_than(self, t: float):
        for f in self.features.values():
            f.clean_older_than(t)
        self.features = {i: f for i, f in self.features.items() if f.num_obs() > 0}
        tk = _tkey(t)
        self._by_time = {tt: ids for tt, ids in self._by_time.items() if tt >= tk}

    def __len__(self):
        return len(self.features)

    # -- serialization (checkpoint/resume) --------------------------------
    def to_dict(self) -> dict:
        return {
            str(i): {str(c): lst for c, lst in f.obs.items()}
            for i, f in self.features.items()
        }

    @classmethod
    def from_dict(cls, d: dict) -> "FeatureDatabase":
        db = cls()
        for i, obs in d.items():
            f = Feature(int(i))
            for c, lst in obs.items():
                for o in lst:
                    f.add(o[0], int(c), o[1], o[2])
                    db._by_time.setdefault(_tkey(o[0]), set()).add(f.feat_id)
            db.features[int(i)] = f
        return db

